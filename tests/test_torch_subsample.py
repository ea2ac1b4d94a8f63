"""The subsampling operator `asr_port::subsample` on the CPU: the path
`ConvSubsample` takes when it records no gradient at bfloat16 gives the
autograd path's output, its fake gives the kernel's shape, and exported
programs call it. (Its CUDA kernel is held to `subsample_plain` in
`test_torch_cuda.py`.)"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc
from pytorch_end2end_speech_recognition_tpu_torch.ops import (
    subsample_kernel as sk,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
    ModelConfig,
)


def _module(n_mels, C, dtype, seed=0):
    torch.manual_seed(seed)
    cfg = ModelConfig(encoder_dim=32, subsample_channels=C, dtype=dtype,
                      residual_dtype="float32")
    return tenc.ConvSubsample(n_mels, 32, cfg)


def _inputs(B, T, n_mels, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, T, n_mels)).astype(np.float32))
    lens = torch.tensor([T, 1] + [int(v) for v in rng.integers(1, T + 1, B - 2)])
    return x, lens


@pytest.mark.parametrize("T,n_mels", [(37, 80), (40, 81), (9, 13), (64, 8)])
def test_operator_path_matches_autograd_path(T, n_mels, monkeypatch):
    """bf16 under no_grad: the operator (its CPU version) runs, once, and
    gives the autograd path's output bit for bit; float32 under no_grad
    keeps the plain path. Odd and even T and n_mels, lengths 1 and T."""
    calls = []

    def counted(*a):
        calls.append(1)
        return sk.subsample(*a)

    monkeypatch.setattr(tenc, "subsample", counted)
    x, lens = _inputs(4, T, n_mels, seed=T)
    m = _module(n_mels, 16, "bfloat16")
    want, want_lens = m(x, lens)
    assert want.requires_grad and not calls
    with torch.no_grad():
        got, got_lens = m(x, lens)
    assert len(calls) == 1
    assert torch.equal(got, want.detach()) and torch.equal(got_lens, want_lens)
    m32 = _module(n_mels, 16, "float32")
    with torch.no_grad():
        m32(x, lens)
    assert len(calls) == 1


@pytest.mark.parametrize("T,n_mels,C", [(37, 80, 16), (40, 81, 32),
                                        (2998, 80, 256), (1, 1, 48)])
def test_operator_fake_gives_the_kernel_shape(T, n_mels, C):
    """The fake (what export and compilation see) gives (B, T2, F2 C) in
    the weights' dtype, T2 = ceil(ceil(T / 2) / 2), as the CPU version."""
    bf = torch.bfloat16
    with FakeTensorMode():
        args = (torch.empty(2, T, n_mels), torch.empty(2, dtype=torch.int64),
                torch.empty(C, 1, 3, 3, dtype=bf), torch.empty(C, dtype=bf),
                torch.empty(C, C, 3, 3, dtype=bf), torch.empty(C, dtype=bf))
        out = sk.subsample(*args)
    F2 = ((n_mels + 1) // 2 + 1) // 2
    assert out.shape == (2, ((T + 1) // 2 + 1) // 2, F2 * C)
    assert out.dtype == bf
    if T < 100:
        real = sk.subsample(torch.zeros(2, T, n_mels), torch.tensor([T, 1]),
                            *(torch.zeros_like(a, device="cpu")
                              for a in (torch.empty(C, 1, 3, 3, dtype=bf),
                                        torch.empty(C, dtype=bf),
                                        torch.empty(C, C, 3, 3, dtype=bf),
                                        torch.empty(C, dtype=bf))))
        assert real.shape == out.shape and real.dtype == out.dtype


def test_operator_passes_opcheck():
    x, lens = _inputs(3, 21, 17)
    m = _module(17, 16, "bfloat16")
    w = (m.conv1.weight, m.conv1.bias, m.conv2.weight, m.conv2.bias)
    torch.library.opcheck(sk.subsample_op,
                          (x, lens, *(t.detach().to(torch.bfloat16) for t in w)))


def test_exported_greedy_program_calls_the_operator(tmp_path):
    """A bf16 Conformer's greedy program (what a serving bundle exports)
    holds one `asr_port::subsample` node, and the saved program, loaded in a
    fresh process that imports the serving package and no model code, gives
    the live tokens."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
        GreedyProgram,
    )

    cfg = AsrConfig()
    m = cfg.model
    m.encoder, m.encoder_layers, m.encoder_dim = "conformer", 1, 32
    m.encoder_ffn_dim, m.encoder_heads, m.subsample_channels = 64, 2, 16
    m.vocab_size, m.ctc_weight, m.dtype = 16, 1.0, "bfloat16"
    model = AsrModel(cfg, device="cpu", seed=3).eval()
    program = GreedyProgram(model).eval()
    sr = cfg.frontend.sample_rate
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, sr // 2)).astype(np.float32) * 0.1)
    lens = torch.tensor([sr // 2, sr // 4], dtype=torch.int32)
    with torch.no_grad():
        ep = torch.export.export(program, (audio, lens))
        want = program(audio, lens)
    targets = [str(n.target) for n in ep.graph.nodes]
    assert targets.count("asr_port.subsample.default") == 1, targets
    torch.export.save(ep, tmp_path / "greedy.pt2")
    torch.save({"audio": audio, "lens": lens}, tmp_path / "req.pt")
    pkg = "pytorch_end2end_speech_recognition_tpu_torch"
    code = f"""
import json, sys, torch
import {pkg}.serving
req = torch.load(sys.argv[2])
with torch.no_grad():
    toks, n = torch.export.load(sys.argv[1]).module()(req["audio"], req["lens"])
mods = sorted(m for m in sys.modules if m.startswith("{pkg}.models"))
print(json.dumps({{"toks": toks.tolist(), "n": n.tolist(), "mods": mods}}))
"""
    res = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "greedy.pt2"),
         str(tmp_path / "req.pt")], cwd=Path(__file__).resolve().parents[1],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["mods"] == []
    assert out["toks"] == want[0].tolist() and out["n"] == want[1].tolist()
