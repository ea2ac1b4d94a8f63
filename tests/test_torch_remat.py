"""`model.remat` in the port: each Transformer or Conformer block runs under
`torch.utils.checkpoint` in training, as the JAX package wraps each block in
`jax.checkpoint`. Dropout and the fused FFN's seed draw from the layer's
explicit `torch.Generator`, which checkpoint does not restore, so the
recompute must replay the generator's draws: with remat on and off the loss
and every gradient are bit-identical at dropout 0.1, and the generator ends
in the same state. Small flagship (2 Conformer layers, d64, H4) and small
rung 3 (2 Transformer layers, d64, H4), `ffn_impl` torch and cuda (on the
CPU the latter takes the fused block's plain version with its hash mask).
float32 on the CPU; inputs made with numpy from a seed."""

import numpy as np
import pytest
import torch

from pytorch_end2end_speech_recognition_tpu_torch.configs import presets
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc

PRESETS = {"flagship_conformer": tenc.ConformerEncoder,
           "libri100_transformer": tenc.TransformerEncoder}
N_MELS = 20


def _encoder(preset: str, ffn_impl: str, remat: bool, rate: float = 0.1):
    cfg = getattr(presets, preset)().model
    cfg.encoder_layers, cfg.encoder_dim, cfg.encoder_heads = 2, 64, 4
    cfg.encoder_ffn_dim = 256
    cfg.dtype, cfg.residual_dtype = "float32", "float32"
    cfg.encoder_dropout = rate
    cfg.ffn_impl, cfg.attn_impl = ffn_impl, "torch"
    cfg.remat = remat
    torch.manual_seed(0)
    enc = PRESETS[preset](N_MELS, cfg)
    if enc.rel is not None:  # a table that moves the output
        with torch.no_grad():
            enc.rel.table.normal_(0.0, 1.0, generator=torch.Generator()
                                  .manual_seed(1))
    return enc


def _step(enc, T: int, seed: int = 3):
    """Loss sum(out * cot) of one training forward on (B=3, T, 20) features
    with lengths T / 2T/3 / 0, its gradients in every parameter, and the
    generator's state after the backward."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((3, T, N_MELS)).astype(
        np.float32))
    lens = torch.tensor([T, 2 * T // 3, 0])
    gen = torch.Generator().manual_seed(11)
    out, _ = enc(x, lens, train=True, generator=gen)
    cot = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    loss = (out * cot).sum()
    names, params = zip(*enc.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), dict(zip(names, grads)), gen.get_state()


def _count_forwards(enc) -> list:
    """A one-element list that counts the blocks' forward calls."""
    calls = [0]
    for blk in enc.blocks:
        def counted(*a, _f=blk.forward, **k):
            calls[0] += 1
            return _f(*a, **k)
        blk.forward = counted
    return calls


@pytest.mark.parametrize("ffn_impl", ["torch", "cuda"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_remat_is_bit_identical_at_dropout(preset, ffn_impl):
    """Remat on and off: the same loss and every gradient bit for bit, the
    generator in the same state after the step; the blocks' forwards run
    again in the backward only with remat (the recompute). Dropout at 0.1
    must move the output, or the check would not see a wrong mask."""
    runs = {}
    for remat in (False, True):
        enc = _encoder(preset, ffn_impl, remat)
        fused = [m.fused for m in enc.modules()
                 if isinstance(m, tenc.FfnBlock)]
        assert fused and all(f == (ffn_impl == "cuda") for f in fused)
        calls = _count_forwards(enc)
        runs[remat] = (*_step(enc, 61), calls[0])
    (l0, g0, s0, c0), (l1, g1, s1, c1) = runs[False], runs[True]
    assert c0 == 2 and c1 == 4  # two blocks; each recomputed once with remat
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        a, b = g0[name], g1[name]
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert torch.equal(s0, s1)
    l_nodrop = _step(_encoder(preset, ffn_impl, False, rate=0.0), 61)[0]
    assert not torch.equal(l0, l_nodrop)


def test_remat_generator_state_matches_a_plain_step():
    """The generator's state after a remat step equals its state after a
    plain step, and both differ from its start (the step drew from it)."""
    start = torch.Generator().manual_seed(11).get_state()
    states = [_step(_encoder("flagship_conformer", "cuda", r), 40)[2]
              for r in (False, True)]
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], start)


def test_remat_on_the_flash_path():
    """Past FLASH_T encoder frames the bias travels as diagonals into the
    flash attention; remat stays bit-identical there (T = 3,260 frames ->
    T' 815)."""
    res = [_step(_encoder("flagship_conformer", "torch", r), 3260)
           for r in (False, True)]
    assert torch.equal(res[0][0], res[1][0])
    for name, g in res[0][1].items():
        assert (g is None and res[1][1][name] is None) or torch.equal(
            g, res[1][1][name]), name
    assert torch.equal(res[0][2], res[1][2])


def test_remat_is_off_outside_training():
    """Evaluation runs the blocks once, remat or not, with no generator."""
    enc = _encoder("libri100_transformer", "torch", True)
    calls = _count_forwards(enc)
    x = torch.zeros(1, 40, N_MELS)
    with torch.no_grad():
        enc(x, torch.tensor([40]))
    assert calls[0] == 2
