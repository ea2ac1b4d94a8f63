"""The cgMLP branch of every E-Branchformer block (`asr.cgmlp`): for each
row's real encoder frames t, the two linears (2 t D U and t U D) and the
depthwise convolution on the gate half (t U K) a layer in bf16; the
layer's bf16 weights and biases and float32 layer-norm scales and shifts
(D and U / 2 wide) read once, its bf16 input read and output written
once."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D, U, K = (m["encoder_layers"], m["encoder_dim"], m["cgmlp_units"],
                  m["cgmlp_kernel"])
    t = sum(batch["enc_lens"])
    flops = L * (3 * t * D * U + t * U * K)
    weights = D * U + U + U // 2 * D + D + U // 2 * K + U // 2
    layer = 2 * weights + 4 * 2 * (D + U // 2) + 2 * 2 * t * D
    return {"flops": flops, "bytes": L * layer, "precision": "bf16"}
