"""Model FLOPs of one hybrid training step of an E-Branchformer
CTC/attention model, from each row's real frames and tokens: the log-mel
forward (no gradient), then three times the forward of the subsampling,
the encoder, the CTC head and the Transformer decoder on U + 1 positions
(forward, and the two products of each one's backward), less the first
convolution's input gradient, which nothing needs. bf16."""

import importlib.util
from pathlib import Path

from portbench import shapes


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_counts_{name}", Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve = _load("ebranchformer_serve")
decoder = _load("conformer_train").decoder


def work(cfg: dict, batch: dict) -> dict:
    total = 0
    for s, t, u in zip(batch["audio_lens"], batch["enc_lens"],
                       batch["token_lens"]):
        n = shapes.frames(s, cfg["frontend"])
        c1, c2 = serve.subsample(cfg, n)
        fwd = c1 + c2 + serve.encoder(cfg, t) + decoder(cfg, t, u + 1)
        total += serve.frontend(cfg, n) + 3 * fwd - c1
    return {"flops": total, "bytes": 0, "precision": "bf16"}
