"""The work counts: each model count equals what
`torch.utils.flop_counter.FlopCounterMode` counts on the plain reference at
a small ragged size (each row alone, unpadded, so both see the same work),
and each kernel count equals a hand-worked shape."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, shapes
from portbench.reference import conformer_ctc as ref
from portbench.reference.common import Prec, logmel, mel_filterbank
from portbench.tests import small
from portbench.weights import make_weights

SR = 16000


def samples(frames: int) -> int:
    """Samples that give exactly `frames` log-mel frames."""
    return 400 + 160 * (frames - 1)


def flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_serve_model_count_matches_flop_counter():
    doc = small.config_doc()
    cfg = doc["config"]
    w = make_weights(ref, cfg, doc["init"], 3, "cpu")
    for n in (samples(99), samples(150), samples(171)):
        audio = torch.randn(1, n, generator=torch.Generator().manual_seed(n))
        lens = torch.tensor([n])

        def fwd():
            ref.serve_reference(w, {"audio": audio, "audio_lens": lens},
                                None, cfg, Prec("fp32"), 1)

        want = harness.count("conformer_serve", cfg,
                             {"B": 1, "grid": n, "audio_lens": [n],
                              "enc_lens": [ref.enc_len(n, cfg["frontend"])]}
                             )["flops"]
        assert flops(fwd) == want


def test_train_model_count_matches_flop_counter():
    doc = small.config_doc()
    cfg = doc["config"]
    m = cfg["model"]
    w = make_weights(ref, cfg, doc["init"], 4, "cpu")
    for n, u in ((samples(120), 5), (samples(161), 9)):
        audio = torch.randn(1, n, generator=torch.Generator().manual_seed(n))
        lens = torch.tensor([n])
        tokens = torch.arange(3, 3 + u)[None]
        tlens = torch.tensor([u])

        def step():
            P = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            with torch.no_grad():
                feats, flens = logmel(audio, lens, cfg["frontend"],
                                      Prec("fp32"))
            enc, elens = ref.encode(P, feats, flens, m, Prec("fp32"))
            logp = ref.decoder_logp(P, enc, elens, tokens, m, Prec("fp32"))
            loss = ref.hybrid_loss_sum(ref.ctc_logits(P, enc, Prec("fp32")),
                                       elens, logp, tokens, tlens, m)
            torch.autograd.grad(loss, list(P.values()), allow_unused=True)

        want = harness.count("conformer_train", cfg,
                             {"B": 1, "grid": n, "audio_lens": [n],
                              "token_lens": [u],
                              "enc_lens": [ref.enc_len(n, cfg["frontend"])]}
                             )["flops"]
        # FlopCounterMode counts a grouped convolution's weight gradient as
        # if it were dense: the depthwise convolution's, D times its
        # forward instead of once
        t = ((n - 400) // 160 + 2) // 2
        t = (t + 1) // 2
        dw = 2 * t * m["encoder_dim"] * m["conformer_kernel"]
        over = m["encoder_layers"] * (m["encoder_dim"] - 1) * dw
        assert flops(step) == want + over


# encoder frames: 99 log-mel frames -> 25, 40 -> 10; the grid's 120 -> 30
BATCH = {"B": 2, "grid": samples(120), "audio_lens": [samples(99),
                                                      samples(40)],
         "token_lens": [3, 2], "enc_lens": [25, 10], "enc_grid": 30}
CFG = {"frontend": small.config_doc()["config"]["frontend"],
       "model": {"encoder_layers": 2, "encoder_dim": 8, "encoder_heads": 2}}


def test_a_batch_is_described_by_its_familys_lengths():
    cfg = small.config_doc()["config"]
    batch = {"audio": torch.zeros(2, BATCH["grid"]),
             "audio_lens": torch.tensor(BATCH["audio_lens"]),
             "token_lens": torch.tensor(BATCH["token_lens"])}
    assert shapes.describe(batch, cfg, ref) == BATCH


def test_attention_forward_counts():
    # 2 layers x 4 T^2 D over T 25 and 10; q, k, v, o bf16 of the real
    # rows, 2 x (2 x 30 - 1) float32 diagonals a layer
    for name in ("attention_fwd", "flash_fwd"):
        w = harness.count(name, CFG, BATCH)
        assert w["flops"] == 2 * 4 * (625 + 100) * 8 == 46400
        assert w["bytes"] == 2 * ((25 + 10) * 4 * 8 * 2 + 2 * 59 * 4) == 5424
        assert w["precision"] == "bf16"


def test_attention_backward_count():
    w = harness.count("attention_bwd", CFG, BATCH)
    assert w["flops"] == 2 * 10 * 725 * 8 == 116000
    # q, k, v, o, g read and dq, dk, dv written (bf16), (H, T) float32
    # statistics, the diagonals' float32 gradient
    assert w["bytes"] == 2 * (35 * (8 * 8 * 2 + 2 * 4) + 2 * 59 * 4) == 10464


def test_ctc_counts():
    # lattice cells: 25 x 7 + 10 x 5 = 225
    a = harness.count("ctc_alpha", CFG, BATCH)
    b = harness.count("ctc_beta", CFG, BATCH)
    assert (a["flops"], a["bytes"], a["precision"]) == (1800, 1800, "fp32")
    assert (b["flops"], b["bytes"], b["precision"]) == (2700, 2700, "fp32")


def test_logmel_count():
    # 80 HTK filters over 257 bins of a 512-point DFT at 16 kHz read bins
    # 1..256 (0 Hz has weight 0); each bin inside two triangles but the
    # ends of the first and last
    w = harness.count("logmel", CFG, BATCH)
    frames = 99 + 40
    bins = 256
    nnz = int((mel_filterbank(80, 512, SR, 0.0, None) != 0).sum())
    assert 2 * bins - 40 <= nnz <= 2 * bins
    assert w["flops"] == frames * (2 * 400 * 2 * bins + 3 * bins + 2 * nnz)
    assert w["bytes"] == (4 * sum(BATCH["audio_lens"]) + 2 * 400 * 2 * bins
                          + 4 * frames * 80)
