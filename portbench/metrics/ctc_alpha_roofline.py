"""Percent of its roofline of the CTC forward recursion
(`ctc_alpha_kernel`): `counts/ctc_alpha`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "ctc_alpha_kernel" in n, "ctc_alpha")
