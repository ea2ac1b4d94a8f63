"""The E-Branchformer CTC family (`owsm_v31_medium`) on the CPU at a small
size (2 layers, d 64, 4 heads, cgMLP 128, kernels 7, vocab 32): the
harness reaches `correct` in serve mode and in train mode with dropout
replayed; its controls read not correct (a served token altered, the
float8 reference in the program's place); the model counts equal what
`FlopCounterMode` counts on the reference; the cgMLP, merge and FFN
counts equal what it counts inside the program's modules and a
hand-worked shape, as does the no-bias attention's, whose roofline reads
that kernel alone; the new span readers add up with the others to the
busy time, and read nothing of a program without the spans."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, roofline, spans
from portbench.reference import ebranchformer_ctc as ref
from portbench.reference.common import Prec, logmel
from portbench.tests import small
from portbench.tests.test_portbench_spans import (
    MAIN,
    Events,
    FakeTracer,
)
from portbench.weights import make_weights

CELL = "owsm_v31_medium.serve.30s"
TRAIN_LIMITS = "conformer_l.train.30s"   # no train cell of this family
SERVE_READERS = ("frontend_ms.serve", "subsample_ms.serve", "mhsa_ms.serve",
                 "ffn_ms.serve", "cgmlp_ms.serve", "merge_ms.serve",
                 "block_self_ms.serve", "head_ms.serve",
                 "unspanned_ms.serve")


def config_doc() -> dict:
    doc = small.config_doc("owsm_v31_medium")
    doc["config"]["model"].update(encoder_heads=4, decoder_heads=4,
                                  decoder_ffn_dim=0, cgmlp_units=128,
                                  cgmlp_kernel=7, merge_kernel=7)
    return doc


def run_small(mix, limits, seed=11, seconds=0.3):
    return harness.run(CELL, seed, seconds, False, torch.device("cpu"),
                       small.bench(), files=(config_doc(), mix, limits))


@pytest.mark.parametrize("mix,limits", [
    (small.SERVE_MIX, CELL), (small.TRAIN_MIX, TRAIN_LIMITS)])
def test_sound_runs_are_correct(mix, limits):
    doc = config_doc()
    assert doc["family"] == "ebranchformer_ctc"
    assert doc["config"]["model"]["encoder_dropout"] > 0  # replayed
    r = run_small(mix, small.limits(limits))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_a_served_token_altered_is_not_correct(monkeypatch):
    from pytorch_end2end_speech_recognition_tpu_torch.ops import ctc

    real = ctc.ctc_greedy_decode

    def altered(logits, lens):
        hyp, hyp_lens = real(logits, lens)
        hyp = hyp.clone()
        hyp[:, 0] = 1 + hyp[:, 0] % (logits.shape[-1] - 1)
        return hyp, torch.clamp(hyp_lens, min=1)

    monkeypatch.setattr(ctc, "ctc_greedy_decode", altered)
    r = run_small(small.SERVE_MIX, small.limits(CELL))
    assert not r["correct"]
    assert r["checks"]["tokens_differ"]["value"] > 0


def test_the_float8_reference_in_the_programs_place_is_not_correct(
        monkeypatch):
    from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import (
        ctc_greedy_decode,
    )

    cfg = config_doc()["config"]
    fam = harness.load_family("ebranchformer_ctc")

    def control(model, batch):
        w = {n: p.detach() for n, p in model.named_parameters()}
        logits, lens = fam.ref.serve_reference(w, batch, None, cfg,
                                               Prec("fp8"), 8)
        hyp, hyp_lens = ctc_greedy_decode(logits, lens)
        return torch.cat([hyp_lens[:, None], hyp], dim=1).cpu(), logits

    monkeypatch.setattr(fam.path, "serve_request", control)
    r = run_small(small.SERVE_MIX, small.limits(CELL))
    assert not r["correct"]
    assert (r["checks"]["logit_rel_err"]["value"]
            > r["checks"]["logit_rel_err"]["limit"])


# ---------------------------------------------------------------- counts
def samples(frames: int) -> int:
    return 400 + 160 * (frames - 1)


def flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def one_row(n: int, **extra) -> dict:
    fe = config_doc()["config"]["frontend"]
    return {"B": 1, "grid": n, "audio_lens": [n],
            "enc_lens": [ref.enc_len(n, fe)], **extra}


@pytest.mark.parametrize("frames", [99, 150, 171])
def test_serve_model_count_matches_flop_counter(frames):
    doc = config_doc()
    cfg = doc["config"]
    w = make_weights(ref, cfg, doc["init"], 3, "cpu")
    n = samples(frames)
    audio = torch.randn(1, n, generator=torch.Generator().manual_seed(n))
    got = flops(lambda: ref.serve_reference(
        w, {"audio": audio, "audio_lens": torch.tensor([n])}, None, cfg,
        Prec("fp32"), 1))
    assert got == harness.count("ebranchformer_serve", cfg,
                                one_row(n))["flops"]


@pytest.mark.parametrize("frames,u", [(120, 5), (161, 9)])
def test_train_model_count_matches_flop_counter(frames, u):
    doc = config_doc()
    cfg = doc["config"]
    m = cfg["model"]
    w = make_weights(ref, cfg, doc["init"], 4, "cpu")
    n = samples(frames)
    audio = torch.randn(1, n, generator=torch.Generator().manual_seed(n))
    tokens, tlens = torch.arange(3, 3 + u)[None], torch.tensor([u])

    def step():
        P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
        with torch.no_grad():
            feats, flens = logmel(audio, torch.tensor([n]), cfg["frontend"],
                                  Prec("fp32"))
        enc, elens = ref.encode(P, feats, flens, m, Prec("fp32"))
        logp = ref.decoder_logp(P, enc, elens, tokens, m, Prec("fp32"))
        loss = ref.hybrid_loss_sum(ref.ctc_logits(P, enc, Prec("fp32")),
                                   elens, logp, tokens, tlens, m)
        torch.autograd.grad(loss, list(P.values()), allow_unused=True)

    want = harness.count("ebranchformer_train", cfg,
                         one_row(n, token_lens=[u]))["flops"]
    # FlopCounterMode counts a grouped convolution's weight gradient as if
    # it were dense: each depthwise convolution's, C times its forward
    t = one_row(n)["enc_lens"][0]
    U, D = m["cgmlp_units"], m["encoder_dim"]
    over = m["encoder_layers"] * (
        (U // 2 - 1) * t * U * m["cgmlp_kernel"]
        + (2 * D - 1) * 4 * t * D * m["merge_kernel"])
    assert flops(step) == want + over


def module_flops(cfg: dict, frames: int) -> dict:
    """FLOPs that `FlopCounterMode` counts inside the program's modules of
    one serving forward of one unpadded row, by module path."""
    path = harness.load_family("ebranchformer_ctc").path
    _, model = path.build(cfg, "cpu")
    n = samples(frames)
    audio = torch.randn(1, n, generator=torch.Generator().manual_seed(n))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.encode(audio, torch.tensor([n]))
    return {k: sum(v.values()) for k, v in fc.get_flop_counts().items()}


@pytest.mark.parametrize("name,modules", [
    ("cgmlp", ("cgmlp",)), ("merge", ("merge",)), ("ffn", ("ff1", "ff2"))])
def test_layer_counts_match_the_programs_modules(name, modules):
    """The cgMLP, merge and FFN counts of one row are the FLOPs counted
    inside those modules of every block of the program (`ffn` is the
    Conformer's count, whose terms hold for this block's macaron
    halves)."""
    cfg = config_doc()["config"]
    frames = 150
    got = module_flops(cfg, frames)
    inside = sum(got[f"EBranchformerEncoder.blocks.{i}.{mod}"]
                 for i in range(cfg["model"]["encoder_layers"])
                 for mod in modules)
    want = harness.count(name, cfg, one_row(samples(frames)))
    assert inside == want["flops"] and want["precision"] == "bf16"


def test_attention_count_matches_the_programs_attention():
    """The no-bias attention count of one row is what `FlopCounterMode`
    counts in each block outside its FFN, cgMLP and merge modules, less
    the q, k, v and o linears (`MhsaBlock.branch` runs inside the block's
    own scope)."""
    cfg = config_doc()["config"]
    m = cfg["model"]
    frames = 150
    got = module_flops(cfg, frames)
    row = one_row(samples(frames))
    t, D = row["enc_lens"][0], m["encoder_dim"]
    attn = 0
    for i in range(m["encoder_layers"]):
        blk = f"EBranchformerEncoder.blocks.{i}"
        attn += got[blk] - sum(got[f"{blk}.{mod}"] for mod in (
            "ff1", "ff2", "cgmlp", "merge")) - 4 * 2 * t * D * D
    want = harness.count("attention_nobias_fwd", cfg, row)
    assert attn == want["flops"] and want["precision"] == "bf16"


# encoder frames 25 and 10 (test_portbench_counts.BATCH)
BATCH = {"B": 2, "grid": samples(120), "audio_lens": [samples(99),
                                                      samples(40)],
         "enc_lens": [25, 10], "enc_grid": 30}
CFG = {"model": {"encoder_layers": 2, "encoder_dim": 8, "cgmlp_units": 32,
                 "cgmlp_kernel": 3, "merge_kernel": 5}}


def test_cgmlp_count():
    w = harness.count("cgmlp", CFG, BATCH)
    # 2 layers over 35 frames: fc1 2 t 8 32, fc2 2 t 16 8, dw 2 t 16 3
    assert w["flops"] == 2 * 35 * (2 * 8 * 32 + 2 * 16 * 8 + 2 * 16 * 3)
    # bf16 fc1 (8 x 32 + 32), fc2 (16 x 8 + 8), dw (16 x 3 + 16); float32
    # scale and shift of both norms (8 and 16); x read, c written
    weights = 2 * (256 + 32 + 128 + 8 + 48 + 16)
    assert w["bytes"] == 2 * (weights + 4 * 2 * 24 + 2 * 2 * 35 * 8)


def test_merge_count():
    w = harness.count("merge", CFG, BATCH)
    # 2 layers over 35 frames: dw 2 t 16 5, proj 2 t 16 8
    assert w["flops"] == 2 * 35 * (2 * 16 * 5 + 2 * 16 * 8)
    # bf16 dw (16 x 5 + 16), proj (16 x 8 + 8); a, c and x read, x written
    assert w["bytes"] == 2 * (2 * (80 + 16 + 128 + 8) + 4 * 2 * 35 * 8)
    assert w["precision"] == "bf16"


def test_attention_nobias_forward_count():
    w = harness.count("attention_nobias_fwd", CFG, BATCH)
    # 2 layers x 4 T^2 D over T 25 and 10; q, k, v, o bf16 of the real rows
    assert w["flops"] == 2 * 4 * (625 + 100) * 8 == 46400
    assert w["bytes"] == 2 * (25 + 10) * 4 * 8 * 2 == 4480
    assert w["precision"] == "bf16"
    # the dense-bias count less its diagonals
    dense = harness.count("attention_fwd", {"model": dict(
        CFG["model"], encoder_heads=2)}, BATCH)
    assert dense["flops"] == w["flops"]
    assert dense["bytes"] - w["bytes"] == 2 * 2 * (2 * 30 - 1) * 4


# ---------------------------------------------------------------- readers
def serve_cycle():
    """Two requests (steps 4 and 5) through every span of the family's
    serving path."""
    e = Events()
    t = 0.0
    for k in (4, 5):
        e.step(k, t, 1000)
        names = ["asr.frontend", "asr.subsample", "asr.rel_bias",
                 "asr.block", "asr.ffn", "asr.mhsa", "asr.cgmlp",
                 "asr.merge", "asr.ffn", "asr.ctc_head", "asr.greedy"]
        for i, name in enumerate(names):
            at = t + 10 + 60 * i
            if name == "asr.block":
                e.span(name, at, 355)
                e.launch(MAIN, at + 345, t + 700, 7)   # the block's own
                continue
            inner = name in ("asr.ffn", "asr.mhsa", "asr.cgmlp", "asr.merge")
            e.span(name, at, 40 if inner else 50)
            e.launch(MAIN, at + 1, at + 5, 3 + i)
        e.launch(MAIN, t + 760, t + 900, 11)           # the ids' copy
        t += 1000
    return e.ev


def load(name):
    return harness.load_module("metrics", name)


def test_serve_readers_add_up_to_the_busy_time():
    ev = serve_cycle()
    c = spans.attribute(ev)
    ctx = harness.Context(config_doc(), small.SERVE_MIX, {}, FakeTracer(ev),
                          [dict(BATCH)] * 6)
    got = {n: load(n).read(ctx) for n in SERVE_READERS}
    assert sum(got.values()) == pytest.approx(c.busy_us / 1e3 / 2)
    assert got["cgmlp_ms.serve"] == pytest.approx(9 / 1e3)
    assert got["merge_ms.serve"] == pytest.approx(10 / 1e3)
    for name, span_us in (("cgmlp", 9), ("merge", 10)):
        least = 2 * roofline.least_seconds(harness.count(
            name, ctx.cfg, BATCH))
        assert load(f"{name}_roofline").read(ctx) == pytest.approx(
            100 * least / (2 * span_us * 1e-6))


def test_the_new_readers_read_nothing_without_the_spans():
    """The parent program, which has no `asr.cgmlp` or `asr.merge`."""
    e = Events()
    e.step(0, 0, 100)
    e.span("asr.block", 0, 50)
    e.launch(MAIN, 1, 10, 30)
    ctx = harness.Context(config_doc(), small.SERVE_MIX, {}, FakeTracer(
        e.ev), [dict(BATCH)])
    for name in ("cgmlp_roofline", "merge_roofline"):
        assert load(name).read(ctx) is None
    for name in ("cgmlp_ms.serve", "merge_ms.serve"):
        assert load(name).read(ctx) == 0.0
    assert load("cgmlp_ms.serve").read(harness.Context(
        config_doc(), small.SERVE_MIX, {}, None)) is None


def test_a_real_profile_of_the_small_model():
    """Every device operation made for an operator of a real CPU profile
    goes to one span: the self times add up to the operations' time (the
    made-up operations of nested operators may overlap, so the busy time
    of their union can be less)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import traffic
    from portbench.tests.test_portbench_spans import (
        device_ops_for_each_operator,
    )

    doc = config_doc()
    path = harness.load_family(doc["family"]).path
    _, model = path.build(doc["config"], "cpu")
    pool = traffic.make_pool(small.SERVE_MIX, doc["config"], 5, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            path.serve_request(model, pool[0])
    ev = device_ops_for_each_operator(spans.events_of(prof))
    c = spans.attribute(ev)
    assert {"asr.frontend", "asr.subsample", "asr.block", "asr.ffn",
            "asr.mhsa", "asr.cgmlp", "asr.merge", "asr.ctc_head",
            "asr.greedy"} <= set(c.self_us)
    ops = sum(e["dur"] for e in ev if e["cat"] == "kernel")
    assert sum(c.self_us.values()) == pytest.approx(ops)
    assert c.self_us[spans.OUTSIDE] < 0.2 * ops


def kernel_tracer(kernels: dict, profiled: list[int]):
    """A `Tracer` whose one cycle ran `kernels` (the profiler's names, with
    their microseconds) over the steps `profiled`."""
    from portbench.trace import Tracer

    tr = Tracer.__new__(Tracer)
    tr.cycles = [{"kernels": list(kernels.items()), "span_us": 1000.0}]
    tr.profiled, tr.finished = profiled, set(profiled)
    return tr


FWD = "void hop::attention_fwd_kernel<(BiasMode){}>(CUtensorMap, int, float)"


@pytest.mark.parametrize("modes,want_us", [
    ((0, 1, 2), 20.0), ((0,), 20.0), ((1, 2), None)])
def test_attention_nobias_roofline_reads_the_no_bias_kernel(modes, want_us):
    """The reader times the kernel without a bias alone, over the no-bias
    count of the profiled requests; nothing where it did not run."""
    us = {0: 20.0, 1: 30.0, 2: 50.0}
    tr = kernel_tracer({FWD.format(b): us[b] for b in modes}, [0, 1])
    ctx = harness.Context(config_doc(), small.SERVE_MIX, {}, tr,
                          [dict(BATCH)] * 2)
    got = load("attention_nobias_fwd_roofline").read(ctx)
    if want_us is None:
        assert got is None
        return
    least = 2 * roofline.least_seconds(harness.count(
        "attention_nobias_fwd", ctx.cfg, BATCH))
    assert got == pytest.approx(100 * least / (want_us * 1e-6))
