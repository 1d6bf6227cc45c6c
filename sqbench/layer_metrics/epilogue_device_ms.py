"""Device milliseconds a frame of every operation other than kernels 1 and 2:
the frame epilogue (``integrators/langevin.frame_epilogue``) and the record
(``connected_correlator`` and its readback)."""

KERNELS = ("chain_frame", "chain_frames_multi")


def read(ctx):
    if not ctx.frames or not ctx.trace.device:
        return None
    other = ctx.trace.device_seconds(exclude=[ctx.kernel(k)["match"] for k in KERNELS])
    return 1e3 * other / ctx.frames
