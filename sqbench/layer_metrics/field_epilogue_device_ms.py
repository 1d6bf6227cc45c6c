"""Device milliseconds a frame of every operation other than kernels 3 and 4
in a field cell: the frame epilogue (``integrators/field.field_frame_epilogue``,
where kernel 3 runs) and the record (``runtime.run_field``: the observables'
reductions and readbacks)."""

KERNELS = ("field_frame", "field_frames_multi")


def read(ctx):
    if not ctx.frames or not ctx.trace.device:
        return None
    other = ctx.trace.device_seconds(exclude=[ctx.kernel(k)["match"] for k in KERNELS])
    return 1e3 * other / ctx.frames
