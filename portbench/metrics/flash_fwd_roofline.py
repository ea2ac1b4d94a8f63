"""Percent of its roofline of the attention forward on the diagonals
(`attention_fwd_kernel<2>`): `counts/flash_fwd`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "attention_fwd_kernel<2>" in n, "flash_fwd")
