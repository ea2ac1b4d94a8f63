"""Percent of its roofline of the attention forward without a bias
(`attention_fwd_kernel<0>`, the absolute-position encoders' attention):
`counts/attention_nobias_fwd`."""

from portbench.roofline import share


def read(ctx):
    return share(ctx, lambda n: "attention_fwd_kernel<0>" in n,
                 "attention_nobias_fwd")
