"""The backward of dense-bias self-attention, every encoder layer, with
the reduction of the dense bias's gradient to the diagonals' (the four
`attn_bwd_*` kernels of `csrc/attention.cu`, `csrc/toeplitz.cu` reduce):
for each row's real frames T, the five products of the backward (QK^T
again, dP, dV, dQ, dK), 10 T^2 D a layer in bf16; q, k, v, the output and
its gradient read once, dq, dk, dv written once (bf16), the float32 row
statistics (H, T) read once and the diagonals' gradient (H, 2T'-1)
written once."""


def work(cfg: dict, batch: dict) -> dict:
    m = cfg["model"]
    L, D, H = m["encoder_layers"], m["encoder_dim"], m["encoder_heads"]
    ts, tg = batch["enc_lens"], batch["enc_grid"]
    flops = L * sum(10 * t * t * D for t in ts)
    nbytes = L * (sum(8 * t * D * 2 + H * t * 4 for t in ts)
                  + H * (2 * tg - 1) * 4)
    return {"flops": flops, "bytes": nbytes, "precision": "bf16"}
