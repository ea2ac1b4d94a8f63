"""Percent of its roofline of the CTC backward (`ctc_beta_kernel`):
`counts/ctc_beta`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "ctc_beta_kernel" in n, "ctc_beta")
