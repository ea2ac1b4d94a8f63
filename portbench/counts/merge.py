"""The merge of every E-Branchformer block (`asr.merge`): for each row's
real encoder frames t, the depthwise convolution over the 2D concatenated
channels (4 t D K) and the 2D -> D projection (4 t D^2) a layer in bf16;
the layer's bf16 weights and biases read once, the two branches' bf16
outputs (2 t D) and the residual stream's input read and its output
written once."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D, K = m["encoder_layers"], m["encoder_dim"], m["merge_kernel"]
    t = sum(batch["enc_lens"])
    flops = L * (4 * t * D * K + 4 * t * D * D)
    weights = 2 * D * K + 2 * D + 2 * D * D + D
    layer = 2 * weights + 2 * 4 * t * D
    return {"flops": flops, "bytes": L * layer, "precision": "bf16"}
