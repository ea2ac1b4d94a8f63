"""Model FLOPs of serving an E-Branchformer CTC model, from each row's real
length: the matrix products and convolutions of the plain reference's
forward (the log-mel and the subsampling as the Conformer counts them,
every block's two FFNs, q, k, v, o, QK^T and PV, the cgMLP's two linears
and depthwise convolution, the merge's depthwise convolution and
projection, the CTC head). Elementwise work is not counted. bf16."""

import importlib.util
from pathlib import Path

from portbench import shapes

_spec = importlib.util.spec_from_file_location(
    "portbench_counts_conformer_serve",
    Path(__file__).with_name("conformer_serve.py"))
conformer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conformer)
frontend, subsample = conformer.frontend, conformer.subsample


def encoder(cfg: dict, t: int) -> int:
    m = cfg["model"]
    D, Fd, U = m["encoder_dim"], m["encoder_ffn_dim"], m["cgmlp_units"]
    layer = (8 * t * D * Fd + 8 * t * D * D + 4 * t * t * D   # FFNs, MHSA
             + 3 * t * D * U + t * U * m["cgmlp_kernel"]      # cgMLP
             + 4 * t * D * D + 4 * t * D * m["merge_kernel"])  # merge
    return m["encoder_layers"] * layer + 2 * t * D * m["vocab_size"]


def work(cfg: dict, batch: dict) -> dict:
    total = 0
    for s, t in zip(batch["audio_lens"], batch["enc_lens"]):
        n = shapes.frames(s, cfg["frontend"])
        c1, c2 = subsample(cfg, n)
        total += frontend(cfg, n) + c1 + c2 + encoder(cfg, t)
    return {"flops": total, "bytes": 0, "precision": "bf16"}
