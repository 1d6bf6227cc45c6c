"""Kernel 3 (``kernels/field_kernel.field_frame``): the least time the card
could take a launch (``work_field.least_seconds``) over the kernel's device
time a launch, in per cent."""

from sqbench import work_field


def read(ctx):
    return work_field.roofline_pct(ctx, "field_frame")
