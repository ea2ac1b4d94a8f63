"""The port stands alone: no module imports JAX, Flax, optax or the JAX
package; config resolution copies instead of mutating; entry points run on
CUDA unless asked for the CPU, and raise without a card."""

import ast
import json
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
    "models.decoder", "ops.rnn", "ops.rnn_kernel", "ops.ffn_kernel",
    "models.encoders", "training.losses", "training.schedules",
    "training.solver", "data.dataset"])
def test_training_slice_modules_stand_alone(module):
    """The training slice's modules exist, are among those imported with JAX
    blocked below, and import neither JAX nor the JAX package (nor optax:
    the optimizer is the port's own)."""
    name = f"{PKG.name}.{module}"
    assert name in MODULES
    path = PKG.joinpath(*module.split(".")).with_suffix(".py")
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "decode.beam", "decode.oracle", "models.lm", "ops.ctc_prefix"])
def test_beam_slice_modules_stand_alone(module):
    """The beam-search slice's modules exist, are among those imported with
    JAX blocked below, and import neither JAX nor the JAX package (the
    oracle keeps its own copy of the sos/eos id)."""
    name = f"{PKG.name}.{module}"
    assert name in MODULES
    path = PKG.joinpath(*module.split(".")).with_suffix(".py")
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "data.manifest", "data.audio", "data.flac", "data.tokenizer",
    "data.synthetic", "data.dataset", "metrics.wer", "utils.metrics_log",
    "training.checkpoint", "training.schedules", "ops.specaugment",
    "ops.frontend", "training.solver", "decode.beam", "cli.train",
    "cli.score", "cli.average_ckpts"])
def test_trainer_host_modules_stand_alone(module):
    """The trainer's host side (its sixteen modules and the beam's text
    path) exists, is among the modules imported with JAX blocked below,
    and imports neither JAX nor the JAX package, not even the JAX
    package's jax-free modules: the port keeps its own copies."""
    name = f"{PKG.name}.{module}"
    assert name in MODULES
    path = PKG.joinpath(*module.split(".")).with_suffix(".py")
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "serving", "serving.export", "cli.decode", "cli.export", "cli.demo",
    "cli.supervise", "cli.main"])
def test_serving_and_cli_modules_stand_alone(module):
    """The serving bundles and the five CLIs exist, are among the modules
    imported with JAX blocked below, and import neither JAX nor the JAX
    package."""
    name = f"{PKG.name}.{module}"
    assert name in MODULES
    path = PKG.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "parallel.cp", "parallel.pp", "utils.profiling", "data.prep",
    "data.prep.prep_an4", "data.prep.prep_wsj",
    "data.prep.prep_librispeech", "native"])
def test_cp_pp_and_host_modules_stand_alone(module):
    """Context and pipeline parallelism, profiling, the corpus converters
    and the native bindings exist, are among the modules imported with
    JAX blocked below, and import neither JAX nor the JAX package; the
    native source is the port's own copy."""
    name = f"{PKG.name}.{module}"
    assert name in MODULES
    path = PKG.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    bad = [n for n in _imported(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    if module == "native":
        assert (PKG / "native" / "asrnative.cpp").is_file()


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
    assert (gpu.frontend.impl, gpu.model.attn_impl, gpu.model.ctc_impl,
            gpu.model.lstm_impl) == ("cuda",) * 4
    assert (cpu.model.dtype, cpu.frontend.dft_dtype) == ("float32",) * 2
    assert (cpu.frontend.impl, cpu.model.attn_impl, cpu.model.ctc_impl,
            cpu.model.lstm_impl) == ("torch",) * 4
    for c in (gpu, cpu):
        assert c.model.ffn_impl == "torch"


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


@pytest.mark.parametrize("name,layers,blocks_per_layer,fused", [
    ("flagship_conformer", 2, 2, True),
    ("libri100_transformer", 2, 1, True),
    ("libri960_conformer", 1, 2, False)])
def test_ffn_impl_cuda_routes_ffn_blocks_as_the_jax_gate(
        monkeypatch, name, layers, blocks_per_layer, fused):
    """With model.ffn_impl='cuda' every FfnBlock calls the fused FFN
    wrapper (on CPU tensors it runs the kernel's plain version) where the
    JAX gate would call its Pallas kernel: at the flagship's and rung 3's
    D 256 / F 1024. At rung 4's D 512 / F 2048 `fits_vmem` is false, and
    the blocks run plain torch, as the JAX package runs XLA there."""
    from pytorch_end2end_speech_recognition_tpu_torch.models import (
        encoders as tenc,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.ops import (
        ffn_kernel as fk,
    )

    cfg = PRESETS[name]()
    m = cfg.model
    m.encoder_layers, m.ffn_impl = layers, "cuda"
    m.dtype = m.residual_dtype = "float32"
    enc = tenc.build_encoder(80, m)
    ffns = [b for b in enc.modules() if isinstance(b, tenc.FfnBlock)]
    assert len(ffns) == layers * blocks_per_layer
    assert all(b.fused == fused for b in ffns)
    calls = []
    plain = fk.ffn_fwd

    def spy(x, *args):
        calls.append(tuple(x.shape))
        return plain(x, *args)

    monkeypatch.setattr(fk, "ffn_fwd", spy)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0, 0.05)
        out, _ = enc(torch.randn(2, 40, 80), torch.tensor([40, 25]))
    assert bool(torch.isfinite(out).all())
    assert len(calls) == (len(ffns) if fused else 0)
    assert all(c == (2 * out.shape[1], m.encoder_dim) for c in calls)


@pytest.mark.parametrize("entry", ["decode", "export", "demo", "bundle"])
def test_serving_entry_points_raise_without_a_card(entry, monkeypatch,
                                                   tmp_path):
    """`cli.decode`, `cli.export` and `cli.demo` at their default device,
    and `load_bundle` of a bundle exported on CUDA, raise on a machine
    without a card instead of running on the CPU."""
    from pytorch_end2end_speech_recognition_tpu_torch.cli import (
        decode,
        demo,
        export,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.data.tokenizer import (
        CharTokenizer,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.serving import (
        load_bundle,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tok = CharTokenizer(charset="abc")
    tok.save(tmp_path / "tokenizer.json")
    cfg = ["--config", "flagship_conformer", "--set",
           f"data.tokenizer_path={tmp_path / 'tokenizer.json'}"]
    if entry == "bundle":
        (tmp_path / "meta.json").write_text(json.dumps({
            "mode": "greedy", "format": "torch.export", "sample_rate": 16000,
            "artifacts": [{"file": "greedy_b1_s1.pt2", "batch": 1,
                           "seconds": 1}],
            "vocab_hash": tok.vocab_hash(), "device": "cuda",
            "config_name": "flagship_conformer"}))
    calls = {
        "decode": lambda: decode.main(cfg + ["--manifest", "none.jsonl"]),
        "export": lambda: export.main(
            ["--config", str(tmp_path / "cfg.json"), "--out-dir",
             str(tmp_path / "b")]),
        "demo": lambda: demo.main(["--workdir", str(tmp_path / "demo"),
                                   "--steps", "1"]),
        "bundle": lambda: load_bundle(tmp_path)}
    if entry == "export":
        c = flagship_conformer()
        c.data.tokenizer_path = str(tmp_path / "tokenizer.json")
        (tmp_path / "cfg.json").write_text(c.to_json())
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
