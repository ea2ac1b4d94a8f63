"""Both FFN halves of every Conformer block, however they run (the fused
kernels or plain torch): for each row's real encoder frames t, the two
products of each half, 8 t D F a layer in bf16; each half's bf16 weights
and biases and float32 layer-norm scale and shift read once, its bf16
input read and output written once."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D, F = m["encoder_layers"], m["encoder_dim"], m["encoder_ffn_dim"]
    t = sum(batch["enc_lens"])
    flops = L * 8 * t * D * F
    half = 2 * (2 * D * F + F + D) + 4 * 2 * D + 2 * 2 * t * D
    return {"flops": flops, "bytes": L * 2 * half, "precision": "bf16"}
