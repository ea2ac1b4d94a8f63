"""Percent of their roofline of the attention backward kernels
(`attn_bwd_*`) and the Toeplitz reduction (`toeplitz_reduce*`) together:
`counts/attention_bwd`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "attn_bwd_" in n or "toeplitz_reduce" in n,
                 "attention_bwd")
