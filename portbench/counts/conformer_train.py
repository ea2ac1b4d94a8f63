"""Model FLOPs of one hybrid training step of a Conformer CTC/attention
model, from each row's real frames and tokens: the log-mel forward (no
gradient), then three times the forward of the subsampling, the encoder,
the CTC head and the Transformer decoder on U + 1 positions (forward, and
the two products of each one's backward), less the first convolution's
input gradient, which nothing needs. bf16."""

import importlib.util
from pathlib import Path

from portbench import shapes

_spec = importlib.util.spec_from_file_location(
    "portbench_counts_conformer_serve",
    Path(__file__).with_name("conformer_serve.py"))
serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(serve)


def decoder(cfg: dict, t: int, u1: int) -> int:
    m = cfg["model"]
    Dd, De = m["decoder_dim"], m["encoder_dim"]
    Fd = m["decoder_ffn_dim"] or 4 * Dd
    block = (8 * u1 * Dd * Dd + 4 * u1 * u1 * Dd      # self-attention
             + 4 * u1 * Dd * Dd + 4 * t * De * Dd     # cross q, o; k, v
             + 4 * u1 * t * Dd + 4 * u1 * Dd * Fd)    # cross scores; FFN
    return m["decoder_layers"] * block + 2 * u1 * Dd * m["vocab_size"]


def work(cfg: dict, batch: dict) -> dict:
    total = 0
    for s, t, u in zip(batch["audio_lens"], batch["enc_lens"],
                       batch["token_lens"]):
        n = shapes.frames(s, cfg["frontend"])
        c1, c2 = serve.subsample(cfg, n)
        fwd = c1 + c2 + serve.encoder(cfg, t) + decoder(cfg, t, u + 1)
        total += serve.frontend(cfg, n) + 3 * fwd - c1
    return {"flops": total, "bytes": 0, "precision": "bf16"}
