"""Kernel 1 (``kernels/chain_kernel.chain_frame``): the least time the card
could take a launch (``work.least_seconds``) over the kernel's device time a
launch, in per cent."""


def read(ctx):
    return ctx.roofline_pct("chain_frame")
