"""Percent of their roofline of the dense-bias attention forward
(`attention_fwd_kernel<1>`) and the Toeplitz expansion
(`toeplitz_expand_kernel`), together: `counts/attention_fwd`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "attention_fwd_kernel<1>" in n
                 or "toeplitz_expand" in n, "attention_fwd")
