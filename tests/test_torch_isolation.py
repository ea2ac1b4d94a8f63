"""The port stands alone: no module imports JAX, Flax, optax or the JAX
package; config resolution copies instead of mutating; entry points run on
CUDA unless asked for the CPU, and raise without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pytorch_end2end_speech_recognition_tpu_torch as port
from pytorch_end2end_speech_recognition_tpu_torch.configs.presets import (
    PRESETS,
    flagship_conformer,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    resolve_device,
)

PKG = Path(port.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "pytorch_end2end_speech_recognition_tpu")
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    assert len(MODULES) > 10
    bad = {}
    for path in PKG.rglob("*.py"):
        for name in _imported(path):
            if name.split(".")[0] in FORBIDDEN:
                bad.setdefault(str(path.relative_to(ROOT)), []).append(name)
    assert not bad, bad
    for chip_smoke in ROOT.glob("chip_smoke.py"):
        names = _imported(chip_smoke)
        assert not [n for n in names if n.split(".")[0] in FORBIDDEN], names


@pytest.mark.parametrize("module", [
    "ops.ctc_kernel", "ops.specaugment", "models.decoder_transformer",
    "training.losses", "training.schedules", "training.solver",
    "data.dataset"])
def test_training_slice_modules_stand_alone(module):
    """The training slice's modules exist, are among those imported with JAX
    blocked below, and import neither JAX nor the JAX package (nor optax:
    the optimizer is the port's own)."""
    name = f"{PKG.name}.{module}"
    assert name in MODULES
    path = PKG.joinpath(*module.split(".")).with_suffix(".py")
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{n!r}] = None" for n in FORBIDDEN)
    code = (f"import sys; {blocked}; import importlib; "
            f"[importlib.import_module(m) for m in {MODULES!r}]")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_resolve_device_copies_and_resolves(name):
    cfg = PRESETS[name]()
    before = cfg.to_dict()
    gpu = resolve_device(cfg, "cuda")
    cpu = resolve_device(cfg, torch.device("cpu"))
    assert cfg.to_dict() == before
    assert gpu is not cfg and cpu is not cfg
    assert (gpu.model.dtype, gpu.model.residual_dtype, gpu.frontend.dft_dtype
            ) == ("bfloat16",) * 3
    assert (gpu.frontend.impl, gpu.model.attn_impl, gpu.model.ctc_impl
            ) == ("cuda",) * 3
    assert (cpu.model.dtype, cpu.frontend.dft_dtype) == ("float32",) * 2
    assert (cpu.frontend.impl, cpu.model.attn_impl, cpu.model.ctc_impl
            ) == ("torch",) * 3
    for c in (gpu, cpu):
        assert (c.model.lstm_impl, c.model.ffn_impl) == ("torch",) * 2


def test_resolve_device_keeps_concrete_values_and_refuses_cuda_on_cpu():
    cfg = flagship_conformer()
    cfg.model.dtype = "float32"
    cfg.model.attn_impl = "torch"
    out = resolve_device(cfg, "cuda")
    assert (out.model.dtype, out.model.attn_impl) == ("float32", "torch")
    assert out.model.residual_dtype == "bfloat16"
    cfg.frontend.impl = "cuda"
    with pytest.raises(ValueError, match="CUDA device"):
        resolve_device(cfg, "cpu")
    cfg.frontend.impl = "pallas"
    with pytest.raises(ValueError, match="expected one of"):
        resolve_device(cfg, "cuda")


def test_config_roundtrip_and_overrides():
    cfg = flagship_conformer()
    again = AsrConfig.from_json(cfg.to_json())
    assert again.to_dict() == cfg.to_dict()
    cfg.override("model.encoder_layers", "3")
    assert cfg.model.encoder_layers == 3
    with pytest.raises(KeyError):
        cfg.override("model.bogus_key", "1")


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
    from pytorch_end2end_speech_recognition_tpu_torch.ops.frontend import (
        Frontend,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = flagship_conformer()
    with pytest.raises(RuntimeError, match="CUDA"):
        AsrModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Frontend(resolve_device(cfg, "cuda").frontend)
    assert resolve_device(cfg, "cuda").frontend.impl == "cuda"
