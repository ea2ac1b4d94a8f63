"""The port's long-audio attention (flash path, the relative bias as float32
diagonals) against the JAX package: the plain versions against the Pallas
flash kernels in interpret mode and the chunked XLA versions, the autograd
Function against autograd through dense attention, and the flagship-small
model and hybrid train step past 768 encoder frames with bridged weights
(the JAX model with attn_impl='pallas', which on the CPU runs its chunked
flash path). float32; inputs made with numpy from a seed."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from jax.experimental.pallas import tpu as pltpu

from pytorch_end2end_speech_recognition_tpu.ops import attention_pallas as ap
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc
from pytorch_end2end_speech_recognition_tpu_torch.ops import attention_kernel as ak

# float32 forward, sums over ~1,000 keys in another order: the tolerance of
# the JAX package's own flash tests (tests/test_flash_attention.py:60)
FWD_TOL = 2e-4
# the backward: the JAX package holds its Pallas backward to the chunked
# one within 1e-5 (tests/test_flash_attention.py:235); so does this
BWD_TOL = 1e-5


def _inputs(B, T, H, Dh, lens, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.standard_normal((B, T, H * Dh)) * scale).astype(
        np.float32)
    q, k, v, g = mk(), mk(), mk(), mk()
    diag = (rng.standard_normal((H, 2 * T - 1)) * 0.2).astype(np.float32)
    return q, k, v, g, diag, np.asarray(lens, np.int32)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def test_toeplitz_expand_offsets_match_jax():
    """Offset blocks (qoff, koff), the chunk the plain versions cut, equal
    the JAX helper's and the dense expansion's slice."""
    rng = np.random.default_rng(1)
    diag = rng.standard_normal((3, 2 * 17 - 1)).astype(np.float32)
    dense = ak.toeplitz_expand(torch.from_numpy(diag), 17, 17).numpy()
    for Tq, Tk, qoff, koff in ((5, 4, 8, 12), (4, 9, 13, 0), (17, 17, 0, 0)):
        blk = ak.toeplitz_expand(torch.from_numpy(diag), Tq, Tk, T=17,
                                 qoff=qoff, koff=koff).numpy()
        ref = np.asarray(ap.toeplitz_expand(jnp.asarray(diag), Tq, Tk,
                                            qoff=qoff, koff=koff, T=17))
        np.testing.assert_array_equal(blk, ref)
        np.testing.assert_array_equal(
            blk, dense[:, qoff:qoff + Tq, koff:koff + Tk])


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_fwd_plain_matches_pallas_interpret_and_chunked(with_bias):
    """T = 1,000 (not a multiple of the 256-row chunk: q and the diagonals
    are padded), ragged lengths; only query rows i < lens[b] are compared
    (rows past a row's length are masked downstream)."""
    B, T, H, Dh = 2, 1000, 2, 64
    q, k, v, _, diag, lens = _inputs(B, T, H, Dh, [T, 613], 0)
    d = diag if with_bias else None
    jargs = [jnp.asarray(a) if a is not None else None
             for a in (q, k, v, d, lens)]
    with pltpu.force_tpu_interpret_mode():
        kernel = np.asarray(ap._flash_fwd_pallas(*jargs, H))
    chunked = np.asarray(ap._attention_xla_chunked(*jargs, H))
    out = ak.flash_fwd_plain(*_t(q, k, v, d, lens), H).numpy()
    valid = np.arange(T)[None, :, None] < lens[:, None, None]
    for ref in (kernel, chunked):
        np.testing.assert_allclose(out * valid, ref * valid, rtol=FWD_TOL,
                                   atol=FWD_TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_bwd_plain_matches_pallas_interpret_and_chunked(with_bias):
    """T = 640, ragged lengths, a cotangent on every row (also past a row's
    length, which both compute alike): dq, dk, dv and ddiag."""
    B, T, H, Dh = 2, 640, 2, 64
    q, k, v, g, diag, lens = _inputs(B, T, H, Dh, [T, T - 173], 7)
    d = diag if with_bias else None
    jq, jk, jv, jg, jlens = (jnp.asarray(a) for a in (q, k, v, g, lens))
    jd = jnp.asarray(d) if with_bias else None
    with pltpu.force_tpu_interpret_mode():
        kernel = ap._flash_bwd_pallas(jq, jk, jv, jd, jlens, jg, H)
    chunked = ap._attention_xla_chunked(jq, jk, jv, jd, jlens, H, g=jg)
    got = ak.flash_bwd_plain(*_t(q, k, v, d, lens, g), H)
    for ref in (kernel, chunked):
        for name, a, b in zip(("dq", "dk", "dv", "ddiag"), got, ref):
            if b is None:
                assert a is None, name
                continue
            assert a.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=BWD_TOL, atol=BWD_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_attention_grad_is_autograd_of_dense_plain(with_bias, plain):
    """The autograd Function (the flash wrappers, which take the plain
    versions on CPU tensors, or `plain=True`) gives autograd's gradients
    through `attention_plain` with the float32-expanded bias, ddiag
    included, at a T that is not a multiple of the chunk; the wrappers
    launch (count) nothing on CPU tensors."""
    B, T, H, Dh = 3, 300, 2, 32
    q, k, v, g, diag, lens = _inputs(B, T, H, Dh, [T, 171, 1], 3, scale=0.5)
    counters = (ak.flash_fwd, ak.flash_bwd)
    before = [f.launches for f in counters]
    grads = []
    for flash in (True, False):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, diag)]
        d = ts[3] if with_bias else None
        if flash:
            out = ak.flash_attention(*ts[:3], d, torch.from_numpy(lens), H,
                                     plain=plain)
        else:
            dense = ak.toeplitz_expand(d, T, T) if with_bias else None
            out = ak.attention_plain(*ts[:3], dense, torch.from_numpy(lens), H)
        (out * torch.from_numpy(g)).sum().backward()
        grads.append([t.grad for t in ts[:3 + with_bias]])
    for name, a, b in zip(("dq", "dk", "dv", "ddiag"), *grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert [f.launches for f in counters] == before


# -------------------------------------- flagship-small past FLASH_T frames
TS_LONG = 33 * 16000        # 3,298 frames -> 825 encoder frames
RAGGED_LONG = 25 * 16000    # 2,498 frames -> 625


@pytest.fixture(scope="module")
def long_case(tmp_path_factory):
    """flagship-small at 2 layers on ~33 s of audio (T' = 825 > FLASH_T) in
    both packages, the JAX model with attn_impl='pallas'; the JAX hybrid
    loss and gradients of `Solver._build_train_step` (replicated, as in
    test_torch_train.py) and the port's `Solver.grads` on the same batch,
    weights and SpecAugment mask."""
    from pytorch_end2end_speech_recognition_tpu.training.losses import (
        hybrid_loss,
    )
    from flax import nnx

    c = case_mod.build(tmp_path_factory.mktemp("flash"), layers=2,
                       Ts=TS_LONG, ragged=RAGGED_LONG, jax_attn_impl="pallas")
    jcfg, arrays, key = c["jcfg"], c["arrays"], c["key"]
    graphdef, params, rest = nnx.split(c["jmodel"], nnx.Param, ...)

    def loss_fn(params):  # training/solver.py:121-142
        model = nnx.merge(graphdef, params, rest)
        k_spec, k_dec = jax.random.split(key)
        enc, enc_lens = model.encode(arrays[0], arrays[1], train=True,
                                     rng=k_spec)
        logits = model.ctc_logits(enc)
        att = model.decoder(enc, enc_lens, arrays[2], arrays[3], train=True,
                            rng=k_dec)
        return hybrid_loss(logits, enc_lens, att, arrays[2], arrays[3],
                           jcfg.model.ctc_weight, jcfg.model.label_smoothing,
                           ctc_impl=jcfg.model.ctc_impl)

    (_, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    c["jmetrics"] = case_mod.scalars(jm)
    c["jgrads"] = case_mod.flat(jg)
    c["tsolver"] = tsolver = case_mod.port_solver(c)
    tm, tg = tsolver.grads(c["batch"], spec_mask=c["mask"])
    c["tmetrics"] = case_mod.scalars(tm)
    c["tgrads"] = dict(zip(tsolver.names, tg))
    return c


def test_long_audio_encoder_and_logits_match_jax(long_case, monkeypatch):
    """encode -> CTC logits on a full and a ragged row (serving, no
    SpecAugment): 825 encoder frames take the flash path in both packages,
    with float32 diagonals and no dense bias; valid frames agree within the
    serving slice's tolerance (test_torch_model.py, ENC_TOL)."""
    from pytorch_end2end_speech_recognition_tpu.models import (
        encoders as jenc,
    )

    jmodel, tmodel = long_case["jmodel"], long_case["tsolver"].model
    audio, lens = long_case["batch"].audio[:2], long_case["batch"].audio_lens[:2]
    jenc_out, jlens = jmodel.encode(jnp.asarray(audio), jnp.asarray(lens))
    jlogits = np.asarray(jmodel.ctc_logits(jenc_out))
    T = jenc_out.shape[1]
    assert T > tenc.FLASH_T
    assert jenc._rel_bias_repr(jmodel.encoder.rel, long_case["jcfg"].model,
                               T)[0] is None
    seen = []
    real = tenc._rel_bias_repr

    def spy(rel, cfg, T):
        out = real(rel, cfg, T)
        seen.append(out)
        return out

    monkeypatch.setattr(tenc, "_rel_bias_repr", spy)
    with torch.inference_mode():
        enc, elens = tmodel.encode(torch.from_numpy(audio),
                                   torch.from_numpy(lens))
        logits = tmodel.ctc_logits(enc).numpy()
    (biases, diags), = seen
    assert biases is None and diags.dtype == torch.float32
    assert tuple(diags.shape) == (2, 4, 2 * T - 1)
    np.testing.assert_array_equal(elens.numpy(), np.asarray(jlens))
    valid = (np.arange(T)[None, :] < np.asarray(jlens)[:, None])[..., None]
    np.testing.assert_allclose(enc.numpy() * valid,
                               np.asarray(jenc_out) * valid, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(logits * valid, jlogits * valid, rtol=1e-4,
                               atol=1e-4)


def test_long_audio_train_step_matches_jax(long_case):
    """One hybrid step past FLASH_T: loss, ctc_loss and att_loss within
    1e-5 relative, each parameter's gradient elementwise within 1e-4 of the
    tensor's largest JAX gradient plus 1e-7 (test_torch_train.py's bounds),
    the relative-bias table's (through the diagonals) included. Two kinds
    are held otherwise. The key projections' biases have zero gradient in
    exact arithmetic (softmax ignores a shift common to a row's scores);
    over 825 keys their float32 noise reaches ~1e-7 on both sides, so they
    are held to be noise: below 1e-4 of the largest gradient of the same
    projection's weight. The subsampling convolutions' gradients sum over
    ~10^5 positions (B x 1,649 x 40) of terms that mostly cancel (CTC loss
    ~700 on random weights), so the float32 noise of everything upstream
    grows with the length: they are held by norm, ||port - jax|| / ||jax||
    <= 2e-3 (measured at most 6.3e-4; 2e-5 at 32 frames)."""
    for k in ("loss", "ctc_loss", "att_loss"):
        assert long_case["tmetrics"][k] == pytest.approx(
            long_case["jmetrics"][k], rel=1e-5), k
    tg, names = long_case["tgrads"], set()
    want_all = dict(bridge._convert(n, g) for n, g in
                    long_case["jgrads"].items())
    for key, want in want_all.items():
        names.add(key)
        got = tg[key].numpy()
        if key.endswith(("mhsa.k.bias", "wk1.bias", "wk2.bias")):
            floor = 1e-4 * float(np.abs(want_all[key[:-4] + "weight"]).max())
            assert np.abs(want).max() < floor and np.abs(got).max() < floor, key
        elif key.startswith("encoder.sub.conv"):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 2e-3, (key, rel)
        else:
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-4 * scale + 1e-7, err_msg=key)
    assert names == set(tg)
    assert "encoder.rel.table" in names
    assert float(tg["encoder.rel.table"].abs().max()) > 0


@pytest.mark.parametrize("B,T", [(2, 70), (3, 129), (1, 1638)])
def test_ddiag_partials_layout_sums_to_plain(B, T):
    """The flash backward's ddiag partial buffer (`ddiag_scratch`), as its
    kernels fill and sum it: the main kernel's tile (batch row b, 128-key
    block kt, head h, 64-query tile qt) owns row ((b n_kt + kt) H + h) n_qt
    + qt, whose column c holds its ds summed along diagonal j - i = 128 kt -
    64 qt + c - 63; the last launch adds, per diagonal, the rows of the
    query tiles whose columns reach it. Filled from random ds at ragged T
    (the last tiles run past T), the rows sum to the plain per-diagonal
    sums."""
    H = 2
    rng = np.random.default_rng(T)
    ds = rng.standard_normal((B, H, T, T))
    rows, cols = ak.ddiag_scratch(B, T, H)
    n_kt, n_qt = -(-T // ak.KEY_BLOCK), -(-T // ak.TILE)
    assert rows == B * n_kt * H * n_qt and cols == ak.DIAG_COLS
    part = np.zeros((rows, cols))
    for b in range(B):
        for kt in range(n_kt):
            k0, k1 = kt * ak.KEY_BLOCK, min(kt * ak.KEY_BLOCK + ak.KEY_BLOCK, T)
            for h in range(H):
                for qt in range(n_qt):
                    q0, q1 = qt * ak.TILE, min(qt * ak.TILE + ak.TILE, T)
                    i = np.arange(q0, q1)[:, None]
                    j = np.arange(k0, k1)[None, :]
                    c = j - i - k0 + q0 + ak.TILE - 1
                    assert c.min() >= 0 and c.max() < cols - 1
                    row = ((b * n_kt + kt) * H + h) * n_qt + qt
                    np.add.at(part[row], c.ravel(), ds[b, h, q0:q1, k0:k1].ravel())
    got = np.zeros((H, 2 * T - 1))
    span = ak.KEY_BLOCK + ak.TILE - 2  # the largest column, 190
    for h in range(H):
        for d in range(2 * T - 1):
            for b in range(B):
                for kt in range(n_kt):
                    X = d - (T - 1) - kt * ak.KEY_BLOCK + ak.TILE - 1
                    lo = max(0, -(X // ak.TILE))
                    hi = min(n_qt - 1, (span - X) // ak.TILE)
                    for qt in range(lo, hi + 1):
                        c = X + ak.TILE * qt
                        assert 0 <= c <= span
                        got[h, d] += part[((b * n_kt + kt) * H + h) * n_qt + qt, c]
    # the plain version sums in float32
    want = ak.toeplitz_reduce_plain(torch.from_numpy(ds.sum(0)), T).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("B,T,H", [(1, 1, 4), (32, 750, 4), (16, 1638, 4),
                                   (8, 750, 8), (3, 65, 2)])
def test_bwd_work_words(B, T, H):
    """The backward's `work` scratch: a float32 (64, 64) dQ partial per
    (batch row, head, 128-key block, 64-query tile): at the flagship's
    shape 151 MB, on long audio 354 MB."""
    n_kt, n_qt = -(-T // ak.KEY_BLOCK), -(-T // ak.TILE)
    words = ak.bwd_work_words(B, T, H)
    assert words == B * H * n_kt * n_qt * ak.TILE * ak.TILE
    assert words * 4 == {(32, 750, 4): 150_994_944,
                         (16, 1638, 4): 354_418_688}.get((B, T, H), words * 4)


def _reduce_plan(T):
    """The reduce kernel's walk of one T x T core (`toeplitz_reduce_kernel`
    in csrc/toeplitz.cu, its constants read from that file): a cluster of
    RED_SEGS blocks for each band of RED_DIAGS diagonals, each block one
    segment of the band's rows in whole tiles of RED_ROWS rows ->
    (constants, [(d0, [(lo, hi) of each segment])])."""
    src = (Path(ak.__file__).parent.parent / "csrc" / "toeplitz.cu").read_text()
    c = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
         for k in ("RED_DIAGS", "RED_ROWS", "RED_SEGS")}
    W, R, S = 2 * T - 1, c["RED_ROWS"], c["RED_SEGS"]
    bands = []
    for d0 in range(0, W, c["RED_DIAGS"]):
        # band_rows(T, d0, d1): diagonal d has rows 0 <= i + d - (T-1) < T
        lo, hi = max(0, T - min(d0 + c["RED_DIAGS"], W)), min(T, W - d0)
        all_tiles = -(-(hi - lo) // R) if hi > lo else 0
        per_seg = -(-all_tiles // S)
        segs = []
        for seg in range(S):
            n_tiles = max(0, min(per_seg, all_tiles - seg * per_seg))
            first = lo + seg * per_seg * R
            segs.append((min(first, hi), min(first + n_tiles * R, hi)))
        bands.append((d0, segs))
    return c, bands


@pytest.mark.parametrize("N,T,P", [(3, 70, 72), (2, 129, 256), (1, 750, 768)])
def test_toeplitz_reduce_partials_layout_sums_to_plain(N, T, P):
    """The Toeplitz reduce's plan (`_reduce_plan`, from the kernel's
    source), as its kernel walks it: the bands of RED_DIAGS diagonals cover
    every diagonal once, their RED_SEGS row segments cover each diagonal's
    core elements once, and summing each diagonal over each segment's rows
    in row order, with the elements outside the T x T core read as zeros
    (the pad band included), then adding the segments' partial sums in
    segment order, gives the plain per-diagonal sums."""
    rng = np.random.default_rng(N + T)
    g = rng.standard_normal((N, P, P))
    W = 2 * T - 1
    got = np.full((N, W), np.nan)
    c, bands = _reduce_plan(T)
    for d0, segs in bands:
        assert len(segs) == c["RED_SEGS"]
        for d in range(d0, min(d0 + c["RED_DIAGS"], W)):
            rows = [i for lo, hi in segs for i in range(lo, hi)]
            core = [i for i in range(T) if 0 <= i + d - (T - 1) < T]
            assert sorted(set(core) - set(rows)) == [] and \
                len(rows) == len(set(rows)), d
            total = np.zeros(N)
            for lo, hi in segs:
                acc = np.zeros(N)
                for i in range(lo, hi):
                    j = i + d - (T - 1)
                    if 0 <= j < T:
                        acc = acc + g[:, i, j]
                total = total + acc
            assert np.isnan(got[:, d]).all()
            got[:, d] = total
    want = ak.toeplitz_reduce_plain(torch.from_numpy(g), T).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
