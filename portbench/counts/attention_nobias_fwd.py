"""Self-attention without a bias of every encoder layer (`csrc/attention.cu`
kNoBias): for each row's real frames T, QK^T and PV, 4 T^2 D a layer in
bf16; q, k, v read and the output written once (bf16)."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D = m["encoder_layers"], m["encoder_dim"]
    ts = batch["enc_lens"]
    flops = L * sum(4 * t * t * D for t in ts)
    nbytes = L * sum(4 * t * D * 2 for t in ts)
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}
