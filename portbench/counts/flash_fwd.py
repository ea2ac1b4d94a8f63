"""Self-attention with the relative bias read as float32 diagonals, every
encoder layer (`csrc/attention.cu` kDiag): the same work as the dense
path, 4 T^2 D a layer for each row's real frames T in bf16, q, k, v read
and the output written once, each layer's diagonals (H, 2T'-1) read once."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D, H = m["encoder_layers"], m["encoder_dim"], m["encoder_heads"]
    ts, tg = batch["enc_lens"], batch["enc_grid"]
    flops = L * sum(4 * t * t * D for t in ts)
    nbytes = L * (sum(4 * t * D * 2 for t in ts) + H * (2 * tg - 1) * 4)
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}
