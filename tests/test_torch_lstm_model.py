"""The LSTM rungs of the port against the JAX package, with the JAX weights
bridged in: `BiLstmEncoder`, `VggExtractor`, `PyramidalBiLstmEncoder` (odd
T, VGG on), the location-aware `AttentionDecoder` (teacher-forced log-probs
and attention maps, with and without scheduled-sampling coins), the
an4_ctc-small and wsj_las-small `AsrModel` encode + CTC logits, and one
wsj_las-small hybrid `Solver.train_step` against the JAX
`Solver.train_step` (loss, every gradient, every parameter after the
update; SpecAugment mask and coins injected, dropout 0). float32 on the
CPU; the JAX model runs its `xla` LSTM (the kernels' plain versions are
held to the Pallas kernels in interpret mode by `test_torch_lstm.py`);
inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_train_case as case_mod
from flax import nnx

from pytorch_end2end_speech_recognition_tpu.configs import presets as jpresets
from pytorch_end2end_speech_recognition_tpu.models import decoder as jdec
from pytorch_end2end_speech_recognition_tpu.models import encoders as jenc
from pytorch_end2end_speech_recognition_tpu_torch import bridge
from pytorch_end2end_speech_recognition_tpu_torch.configs import presets
from pytorch_end2end_speech_recognition_tpu_torch.data.dataset import Batch
from pytorch_end2end_speech_recognition_tpu_torch.models import decoder as tdec
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc

VOCAB = 12
SS = 0.5  # scheduled sampling in the train case: coins at B 3 x 6 steps


def _small(cfg, jax_side: bool):
    """A rung at test width: H 16, decoder/attention 16, 4 location
    filters of width 5, vocab 12, float32, dropout 0."""
    m = cfg.model
    m.encoder_dim = m.decoder_dim = m.embed_dim = m.attention_dim = 16
    m.location_filters, m.location_kernel = 4, 5
    m.vocab_size = VOCAB
    m.dtype = m.residual_dtype = "float32"
    m.encoder_dropout = m.decoder_dropout = 0.0
    m.lstm_impl = "xla" if jax_side else "torch"
    if jax_side:
        cfg.train.prng_impl = "threefry2x32"  # JAX's default: no global change
    return cfg


def _cfgs(name: str, layers: int):
    j = _small(getattr(jpresets, name)(), True)
    t = _small(getattr(presets, name)(), False)
    for c in (j, t):
        c.model.encoder_layers = layers
        c.model.pyramid_layers = layers - 1
    return j, t


def _bridged(jmodule) -> dict:
    sd = {}
    for name, arr in case_mod.flat(jmodule).items():
        key, val = bridge._convert(name, arr)
        sd[key] = torch.from_numpy(np.ascontiguousarray(val))
    return sd


def _jcall(module, *args, **kw):
    """module(*args, **kw) under nnx.jit: one compile for the whole call
    (eagerly, every lax.scan compiles on its own, ~4x slower here)."""
    return nnx.jit(lambda m, *a: m(*a, **kw))(
        module, *(jnp.asarray(a) for a in args))


def _feats(T: int, F: int, lens, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lens), T, F)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("module", ["blstm", "vgg", "pblstm"])
def test_encoder_modules_match_jax(module):
    """float32 outputs within 1e-5 and exact lengths: the BiLSTM stack (3
    layers), the VGG front (floor pools, lengths halved twice) and the
    pyramidal stack with the VGG front at an odd T (pairs trimmed)."""
    jcfg, tcfg = _cfgs("wsj_las", 3)
    F = 20 if module != "blstm" else 12
    if module == "blstm":
        j, t = jenc.BiLstmEncoder(F, jcfg.model, nnx.Rngs(0)), \
            tenc.BiLstmEncoder(F, tcfg.model)
        x, lens = _feats(37, F, [37, 20, 5, 0], 1)
    elif module == "vgg":
        j, t = jenc.VggExtractor(F, jcfg.model, nnx.Rngs(0)), \
            tenc.VggExtractor(F, tcfg.model)
        x, lens = _feats(39, F, [39, 22, 3, 0], 2)
    else:
        j = jenc.PyramidalBiLstmEncoder(F, jcfg.model, nnx.Rngs(0))
        t = tenc.PyramidalBiLstmEncoder(F, tcfg.model)
        x, lens = _feats(61, F, [61, 45, 17, 0], 3)
    t.load_state_dict(_bridged(j))
    ref, ref_lens = _jcall(j, x, lens)
    out, out_lens = t(torch.from_numpy(x), torch.from_numpy(lens))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    _close(out, ref)
    if module == "pblstm":
        assert out.shape[1] == 61 // 4 // 2 // 2 and t.vgg is not None
        assert torch.all(out[3] == 0)


@pytest.mark.parametrize("coins", [False, True])
def test_attention_decoder_matches_jax(coins):
    """Teacher-forced log-probs and attention maps over U+1 steps in
    training mode: without scheduled sampling, and with the coins the JAX
    decoder draws from its key (step 0 included) injected (1e-5)."""
    jcfg, tcfg = _cfgs("wsj_las", 3)
    d_enc, U, T = 10, 6, 13
    j = jdec.AttentionDecoder(d_enc, jcfg.model, nnx.Rngs(0))
    t = tdec.AttentionDecoder(d_enc, tcfg.model)
    t.load_state_dict(_bridged(j))
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((3, T, d_enc)).astype(np.float32)
    enc_lens = np.asarray([13, 7, 1], np.int32)
    tokens = rng.integers(2, VOCAB, (3, U)).astype(np.int32)
    token_lens = np.asarray([6, 3, 0], np.int32)
    tokens *= np.arange(U)[None, :] < token_lens[:, None]
    key = jax.random.PRNGKey(3)
    ss = SS if coins else 0.0
    ref, ref_attn = _jcall(j, enc, enc_lens, tokens, token_lens, train=True,
                           scheduled_sampling=ss, rng=key, return_attn=True)
    c = None
    if coins:
        keys = jax.random.split(key, U + 1)
        c = torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(k, (3,)) < ss) for k in keys], 1))
        assert c.any() and not c.all() and c[:, 0].any()
    out, attn = t(torch.from_numpy(enc), torch.from_numpy(enc_lens),
                  torch.from_numpy(tokens), train=True, scheduled_sampling=ss,
                  coins=c, return_attn=True)
    assert out.shape == (3, U + 1, VOCAB) and attn.shape == (3, U + 1, T)
    _close(out, ref)
    _close(attn, ref_attn)
    assert torch.all(attn[1, :, 7:] == 0) and torch.all(attn[2, :, 1:] == 0)


def _audio(seed: int):
    """Rows of 2 s and 1.5 s and a pad row, with 5 / 3 / 0 tokens."""
    rng = np.random.default_rng(seed)
    Ts = 32000
    audio = (rng.standard_normal((3, Ts)) * 0.1).astype(np.float32)
    audio_lens = np.asarray([Ts, 24000, 0], np.int32)
    audio *= np.arange(Ts)[None, :] < audio_lens[:, None]
    tokens = rng.integers(2, VOCAB, (3, 5)).astype(np.int32)
    token_lens = np.asarray([5, 3, 0], np.int32)
    tokens *= np.arange(5)[None, :] < token_lens[:, None]
    return Batch(audio, audio_lens, tokens, token_lens)


@pytest.mark.parametrize("name,layers", [("an4_ctc", 2), ("wsj_las", 3)])
def test_asr_model_encode_and_ctc_logits_match_jax(name, layers):
    """The serving path, frontend to CTC logits, at a rung's small width
    with its own front (an4_ctc: BiLSTM on log-mel; wsj_las: VGG + pBLSTM),
    the weights bridged; logits within 1e-4 relative + 1e-5."""
    from pytorch_end2end_speech_recognition_tpu.models.asr import (
        AsrModel as JAsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.models.asr import (
        AsrModel,
    )

    jcfg, tcfg = _cfgs(name, layers)
    jm = JAsrModel(jcfg, nnx.Rngs(0))
    tm = AsrModel(tcfg, device="cpu").eval()
    missing, unexpected = tm.load_state_dict(_bridged(jm), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    assert (tm.decoder is None) == (name == "an4_ctc")
    b = _audio(11)
    logits_j, lens_j = nnx.jit(lambda m, a, al: (
        lambda e, el: (m.ctc_logits(e), el))(*m.encode(a, al)))(
        jm, jnp.asarray(b.audio), jnp.asarray(b.audio_lens))
    with torch.no_grad():
        enc, lens = tm.encode(torch.from_numpy(b.audio),
                              torch.from_numpy(b.audio_lens))
        logits = tm.ctc_logits(enc)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    _close(logits, logits_j, rtol=1e-4)


@pytest.fixture(scope="module")
def train_case(tmp_path_factory):
    """wsj_las-small (2 layers, VGG, pyramid 1, speller), scheduled
    sampling 0.5, a cosine schedule without warmup (so the first update
    moves by lr): the JAX Solver's own train step, and the port's Solver
    with the JAX weights, SpecAugment mask and coins injected."""
    from pytorch_end2end_speech_recognition_tpu.models.asr import (
        AsrModel as JAsrModel,
    )
    from pytorch_end2end_speech_recognition_tpu.ops.specaugment import (
        spec_augment,
    )
    from pytorch_end2end_speech_recognition_tpu.training.solver import (
        Solver as JSolver,
    )
    from pytorch_end2end_speech_recognition_tpu_torch.training.solver import (
        Solver,
    )

    jcfg, tcfg = _cfgs("wsj_las", 2)
    for c in (jcfg, tcfg):
        c.train.scheduled_sampling = SS
        c.train.warmup_steps = 0
    jcfg.train.metrics_path = str(tmp_path_factory.mktemp("lstm") / "m.jsonl")
    jmodel = JAsrModel(jcfg, nnx.Rngs(0))

    class _Tok:
        vocab_size = VOCAB

    js = JSolver(jcfg, _Tok(), model=jmodel)
    flat0 = case_mod.flat(jmodel)
    b = _audio(12)
    arrays = [jnp.asarray(a) for a in (b.audio, b.audio_lens, b.tokens,
                                       b.token_lens)]
    key = jax.random.PRNGKey(5)
    # the key paths of Solver.train_step: encode -> features (SpecAugment)
    # and the decoder's per-step coins
    k_enc, k_dec = jax.random.split(key)
    feats, flens = jmodel.frontend(arrays[0], arrays[1])
    mask = np.array(spec_augment(jax.random.split(k_enc)[0],
                                 jnp.ones_like(feats), flens, jcfg.frontend))
    coins = np.stack([np.asarray(jax.random.uniform(k, (3,)) < SS)
                      for k in jax.random.split(k_dec, 5 + 1)], 1)
    from pytorch_end2end_speech_recognition_tpu.training.losses import (
        hybrid_loss,
    )

    graphdef, params, rest = nnx.split(jmodel, nnx.Param, ...)

    def loss_fn(params):  # training/solver.py:121-142
        model = nnx.merge(graphdef, params, rest)
        enc, enc_lens = model.encode(arrays[0], arrays[1], train=True,
                                     rng=k_enc)
        att = model.decoder(enc, enc_lens, arrays[2], arrays[3], train=True,
                            scheduled_sampling=SS, rng=k_dec)
        return hybrid_loss(model.ctc_logits(enc), enc_lens, att, arrays[2],
                           arrays[3], jcfg.model.ctc_weight,
                           jcfg.model.label_smoothing,
                           ctc_impl=jcfg.model.ctc_impl)[0]

    jgrads = case_mod.flat(jax.jit(jax.grad(loss_fn))(params))
    new_params, _, _, jm = js._train_step(
        js.params, js.opt_state, js.rest, *arrays, key,
        jnp.asarray(1.0, jnp.float32))
    tcfg.train.metrics_path = ""
    ts = Solver(tcfg, case_mod.tokenizer_of(VOCAB), device="cpu")
    missing, unexpected = ts.model.load_state_dict(
        bridge.state_dict_from_jax(flat0), strict=False)
    assert not unexpected and all(k.startswith("frontend.") for k in missing)
    inj = dict(spec_mask=torch.from_numpy(mask),
               coins=torch.from_numpy(coins))
    _, tg = ts.grads(b, **inj)
    tstep = case_mod.scalars(ts.train_step(b, **inj))
    return dict(jstep=case_mod.scalars(jm), jnew=case_mod.flat(new_params),
                flat0=flat0, tstep=tstep, lr0=ts.opt.schedule(0),
                tgrads={k: g.numpy() for k, g in zip(ts.names, tg)},
                tnew={k: p.detach().numpy().copy()
                      for k, p in ts.model.named_parameters()},
                mask=mask, coins=coins, jgrads=jgrads)


def test_train_step_metrics_match_jax(train_case):
    """loss, ctc_loss, att_loss and grad_norm of one update (1e-5): the
    mask masks something and the coins replace some inputs."""
    c = train_case
    assert c["mask"].min() == 0 and c["coins"].any()
    for k in ("loss", "ctc_loss", "att_loss", "grad_norm"):
        assert c["tstep"][k] == pytest.approx(c["jstep"][k], rel=1e-5), k


def test_train_step_every_gradient_matches_jax(train_case):
    """Each parameter's gradient elementwise within 1e-4 of the tensor's
    largest JAX gradient, plus 1e-7 absolute: float32 through the VGG
    front, 2 LSTM layers, the 6-step speller and the CTC lattice. The VGG
    convolutions' gradients are sums over every (frame, mel, channel)
    position of cotangents that largely cancel (a bias element of 1e-4
    against a tensor's 4e-3 in this case), so they are held by norm,
    within 2e-3 relative, as `test_torch_flash.py` holds the flagship's
    subsampling convolutions (2.3e-4 measured on the first VGG bias)."""
    c = train_case
    names = set()
    for name, want in c["jgrads"].items():
        key, want = bridge._convert(name, want)
        names.add(key)
        got = c["tgrads"][key]
        if key.startswith("encoder.vgg."):
            err = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert err <= 2e-3, (key, err)
            continue
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=key)
    assert names == set(c["tgrads"])


def test_train_step_update_matches_jax(train_case):
    """Every parameter after one update against the JAX step's own.
    Adam's first step moves an element by lr0 g / (|g| + 1e-8), so each
    element lies within 2 lr0 of JAX's, and those with |g| above 1e-3 of
    the tensor's largest gradient and above a floor within 1e-3 lr0. The
    floor is 1e-7, 10x Adam's eps, above which the move is sign-like, and
    1e-5 for the VGG weights, whose gradients carry ~1e-7 of noise (see
    above). Every parameter of the port is compared. Three quarters of the
    elements with a nonzero gradient are clear of the threshold: the LSTM
    weights' gradients spread over more than three decades (a third of a
    w_ih lies below 1e-3 of its largest)."""
    c = train_case
    lr0 = c["lr0"]
    assert lr0 == pytest.approx(1e-3)
    names, n_clear, n_all = set(), 0, 0
    for name, want in c["jnew"].items():
        key, want = bridge._convert(name, want)
        names.add(key)
        got, g = c["tnew"][key], c["tgrads"][key]
        _, p0 = bridge._convert(name, c["flat0"][name])
        assert np.abs(got - want).max() <= 2 * lr0 * (1 + np.abs(p0).max()), \
            key
        floor = 1e-5 if key.startswith("encoder.vgg.") else 1e-7
        clear = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.abs(g) > floor)
        np.testing.assert_allclose(got[clear], want[clear], rtol=1e-7,
                                   atol=1e-3 * lr0, err_msg=key)
        n_clear += int(clear.sum())
        n_all += int((bridge._convert(name, c["jgrads"][name])[1] != 0)
                     .sum())
    assert names == set(c["tnew"])
    assert n_clear > 0.75 * n_all
