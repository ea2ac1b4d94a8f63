"""The port's E-Branchformer (`model.encoder='e_branchformer'`) against the
benchmark's plain reference of the family
(`portbench/reference/ebranchformer_ctc.py`), on the CPU in float32: a
small model (2 layers, d 64, 4 heads, cgMLP 128, kernels 7, vocab 32)
with every parameter drawn from a seed. The encoder output and CTC logits
on the same features; a row alone and inside a padded batch; one hybrid
train step with dropout replayed (loss and every gradient); `model.remat`;
the named refusals of the paths it does not take; the serving spans; and
`MhsaBlock.forward` as the residual around its `branch`, which the
E-Branchformer calls alone."""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.reference import ebranchformer_ctc as ref
from portbench.reference.common import Prec, logmel
from pytorch_end2end_speech_recognition_tpu_torch.models import encoders as tenc
from pytorch_end2end_speech_recognition_tpu_torch.models.asr import AsrModel
from pytorch_end2end_speech_recognition_tpu_torch.parallel.mesh import Mesh
from pytorch_end2end_speech_recognition_tpu_torch.training.losses import (
    hybrid_loss,
)
from pytorch_end2end_speech_recognition_tpu_torch.utils.config import (
    AsrConfig,
)

REL = 1e-5       # float32 on both sides: only the order of sums differs
GRAD_REL = 1e-4  # a gradient leaf against its norm or the median leaf's
SR = 16000


def small_cfg(**model) -> AsrConfig:
    cfg = AsrConfig()
    m = cfg.model
    m.encoder, m.pos_encoding = "e_branchformer", "absolute"
    m.encoder_layers, m.encoder_dim, m.encoder_heads = 2, 64, 4
    m.encoder_ffn_dim, m.subsample_channels = 128, 16
    m.cgmlp_units, m.cgmlp_kernel, m.merge_kernel = 128, 7, 7
    m.decoder, m.decoder_layers, m.decoder_dim, m.decoder_heads = (
        "transformer", 1, 64, 4)
    m.vocab_size, m.ctc_weight, m.label_smoothing = 32, 0.3, 0.1
    m.dtype = m.residual_dtype = "float32"
    m.attn_impl = m.ctc_impl = "torch"
    cfg.frontend.impl, cfg.frontend.dft_dtype = "torch", "float32"
    for k, v in model.items():
        setattr(m, k, v)
    return cfg


def model_of(cfg: AsrConfig, seed: int = 0) -> AsrModel:
    """The model with every parameter drawn from `seed`: weights at their
    initialiser's scale, biases and LayerNorm shifts N(0, 0.1^2), LayerNorm
    scales 1 + N(0, 0.1^2)."""
    model = AsrModel(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = 0.1 * torch.randn(p.shape, generator=gen)
            if name.endswith("bias"):
                p.copy_(noise)
            elif p.dim() == 1:
                p.add_(noise)
    return model


def weights(model) -> dict:
    return {n: p.detach() for n, p in model.named_parameters()}


def audio_batch(frames=(101, 61, 37), seed=0):
    """Speech-like noise of rows with exactly `frames` log-mel frames,
    padded to the first (the longest)."""
    n = [400 + 160 * (f - 1) for f in frames]
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(n), n[0]), np.float32)
    for i, k in enumerate(n):
        audio[i, :k] = rng.standard_normal(k) * 0.1
    return torch.from_numpy(audio), torch.tensor(n, dtype=torch.int32)


def rel_err(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_encoder_and_ctc_logits_match_the_reference():
    cfg = small_cfg()
    model = model_of(cfg).eval()
    audio, lens = audio_batch()
    feats, flens = logmel(audio, lens, cfg.to_dict()["frontend"],
                          Prec("fp32"))
    with torch.no_grad():
        enc, elens = model.encoder(feats, flens)
        logits = model.ctc_logits(enc)
        want, wlens = ref.encode(weights(model), feats, flens,
                                 cfg.to_dict()["model"], Prec("fp32"))
        want_logits = ref.ctc_logits(weights(model), want, Prec("fp32"))
    assert torch.equal(elens, wlens)
    assert rel_err(enc, want) < REL
    assert rel_err(logits, want_logits) < REL
    # the served path from the audio: the program's front end too
    with torch.no_grad():
        served = model.ctc_logits(model.encode(audio, lens)[0])
        P = weights(model)
        ref_logits, _ = ref.serve_reference(
            P, {"audio": audio, "audio_lens": lens}, None, cfg.to_dict(),
            Prec("fp32"), 2)
    assert rel_err(served, ref_logits) < 10 * REL


def test_a_row_alone_equals_the_row_in_a_padded_batch():
    """Frame counts 101 and 61 have one parity at both stride-2 stages, so
    the subsampling's SAME padding is the same; everything after it sees
    the pad frames only through masks."""
    model = model_of(small_cfg()).eval()
    audio, lens = audio_batch()
    with torch.no_grad():
        enc, elens = model.encode(audio, lens)
        alone, alens = model.encode(audio[1:2, :lens[1]], lens[1:2])
    n = int(alens[0])
    assert n == int(elens[1]) < enc.shape[1]
    torch.testing.assert_close(alone[0, :n], enc[1, :n], rtol=REL,
                               atol=REL)


def program_step(model, audio, lens, tokens, tlens, seed):
    """(loss, gradients by name) of one train-mode pass: dropout from a
    generator seeded `seed`, no SpecAugment."""
    mc = model.cfg.model
    gen = torch.Generator().manual_seed(seed)
    spec = torch.ones(audio.shape[0], 1, 1)
    enc, elens = model.encode(audio, lens, train=True, generator=gen,
                              spec_mask=spec)
    att = model.decoder(enc, elens, tokens, train=True, generator=gen)
    loss, _ = hybrid_loss(model.ctc_logits(enc), elens, att, tokens, tlens,
                          mc.ctc_weight, mc.label_smoothing)
    names, params = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, params, allow_unused=True)))


def reference_step(P0, audio, lens, tokens, tlens, cfg: dict, seed):
    """The same pass by the reference, its dropout masks drawn in the
    program's order (`ref.dropout_shapes`)."""
    m, fe = cfg["model"], cfg["frontend"]
    gen = torch.Generator().manual_seed(seed)
    T = ref.enc_len(audio.shape[1], fe)
    n_enc = 1 + 5 * m["encoder_layers"]
    drops = []
    for j, shp in enumerate(ref.dropout_shapes(
            audio.shape[0], T, tokens.shape[1] + 1, m)):
        r = m["encoder_dropout"] if j < n_enc else m["decoder_dropout"]
        u = torch.rand(shp, generator=gen)
        drops.append(((u < 1.0 - r).float(), 1.0 / (1.0 - r)))
    P = {n: p.clone().requires_grad_(True) for n, p in P0.items()}
    prec = Prec("fp32")
    feats, flens = logmel(audio, lens, fe, prec)
    it = iter(drops)
    enc, elens = ref.encode(P, feats, flens, m, prec, it)
    logp = ref.decoder_logp(P, enc, elens, tokens, m, prec, it)
    loss = ref.hybrid_loss_sum(ref.ctc_logits(P, enc, prec), elens, logp,
                               tokens, tlens, m) / int((tlens > 0).sum())
    names = list(P)
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, list(P.values()), allow_unused=True)))


def test_a_hybrid_train_step_matches_the_reference():
    cfg = small_cfg()
    model = model_of(cfg)
    audio, lens = audio_batch()
    tokens = torch.tensor([[3, 4, 5, 6], [7, 8, 0, 0], [9, 0, 0, 0]])
    tlens = torch.tensor([4, 2, 1])
    loss, grads = program_step(model, audio, lens, tokens, tlens, 5)
    want, wgrads = reference_step(weights(model), audio, lens, tokens, tlens,
                                  cfg.to_dict(), 5)
    assert abs(float(loss - want)) < REL * abs(float(want))
    assert set(grads) == set(wgrads)
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in wgrads.items()}
    med = float(np.median(list(norms.values())))
    for n, g in grads.items():
        gap = float(torch.linalg.vector_norm(g - wgrads[n]))
        assert gap <= GRAD_REL * max(norms[n], med), n


def test_remat_gives_the_same_gradients():
    audio, lens = audio_batch()
    tokens = torch.tensor([[3, 4, 5, 6], [7, 8, 0, 0], [9, 0, 0, 0]])
    tlens = torch.tensor([4, 2, 1])
    loss, grads = program_step(model_of(small_cfg()), audio, lens, tokens,
                               tlens, 7)
    loss_r, grads_r = program_step(model_of(small_cfg(remat=True)), audio,
                                   lens, tokens, tlens, 7)
    assert torch.equal(loss, loss_r)
    for n, g in grads.items():
        assert torch.equal(g, grads_r[n]), n


@pytest.mark.parametrize("field,value", [
    ("pos_encoding", "relative"), ("cp_mode", "ring"), ("pp_stages", 2),
    ("sp", True)])
def test_the_encoder_refuses_what_it_does_not_run(field, value):
    with pytest.raises(ValueError, match=f"e_branchformer.*model.{field}"):
        AsrModel(small_cfg(**{field: value}), device="cpu")


def _streaming(model):
    from pytorch_end2end_speech_recognition_tpu_torch.models.streaming import (
        StreamingEncoder,
    )

    StreamingEncoder(model)


def _export(model, tmp_path):
    from pytorch_end2end_speech_recognition_tpu_torch.serving.export import (
        export_bundle,
    )

    export_bundle(model.cfg, SimpleNamespace(vocab_size=32), tmp_path,
                  device="cpu")


def _tensor_parallel(model):
    from pytorch_end2end_speech_recognition_tpu_torch.parallel.sharding import (
        shard_model,
    )

    shard_model(model, Mesh(dp=1, tp=2, rank=0, device=torch.device("cpu")))


@pytest.mark.parametrize("path,what", [
    (_streaming, "streaming"), (_export, "export_bundle"),
    (_tensor_parallel, r"tensor parallelism \(tp=2\)")])
def test_the_paths_it_does_not_take_refuse_it(path, what, tmp_path):
    model = AsrModel(small_cfg(), device="cpu")
    args = (model, tmp_path) if path is _export else (model,)
    with pytest.raises(ValueError,
                       match=f"{what} does not run the e_branchformer"):
        path(*args)
    assert not list(tmp_path.iterdir())


def test_the_demo_offers_no_e_branchformer():
    from pytorch_end2end_speech_recognition_tpu_torch.cli import demo

    with pytest.raises(SystemExit):
        demo.main(["--workdir", "unused", "--encoder", "e_branchformer"])


def test_mhsa_forward_is_the_residual_around_its_branch():
    cfg = small_cfg(encoder_dropout=0.1).model
    torch.manual_seed(0)
    blk = tenc.MhsaBlock(cfg)
    x = torch.randn(2, 9, 64)
    mask = torch.arange(9)[None, :] < torch.tensor([9, 5])[:, None]
    got = blk(x, mask, train=True, gen=torch.Generator().manual_seed(3))
    y = tenc.dropout(blk.branch(x, mask), blk.rate,
                     torch.Generator().manual_seed(3), True)
    assert torch.equal(got, x + y)


def test_serving_spans_nest_as_the_block():
    from torch.profiler import ProfilerActivity, profile

    model = model_of(small_cfg()).eval()
    audio, lens = audio_batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model.ctc_logits(model.encode(audio, lens)[0])
    names = Counter(e.name for e in prof.events()
                    if e.name.startswith("asr."))
    assert names == {"asr.frontend": 1, "asr.subsample": 1,
                     "asr.rel_bias": 1, "asr.block": 2, "asr.ffn": 4,
                     "asr.mhsa": 2, "asr.cgmlp": 2, "asr.merge": 2,
                     "asr.ctc_head": 1}
