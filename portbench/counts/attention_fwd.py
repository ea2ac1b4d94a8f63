"""Dense-bias self-attention of every encoder layer, with the expansion of
the relative-position diagonals into the dense bias (`csrc/attention.cu`
kDense, `csrc/toeplitz.cu` expand): for each row's real frames T,
QK^T and PV, 4 T^2 D a layer in bf16; q, k, v read and the output written
once (bf16), each layer's float32 diagonals (H, 2T'-1) of the grid read
once."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D, H = m["encoder_layers"], m["encoder_dim"], m["encoder_heads"]
    ts, tg = batch["enc_lens"], batch["enc_grid"]
    flops = L * sum(4 * t * t * D for t in ts)
    nbytes = L * (sum(4 * t * D * 2 for t in ts) + H * (2 * tg - 1) * 4)
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}
