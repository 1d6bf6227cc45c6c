"""Device idle ms a record while the host was in a chain kernel's wrapper
(span ``sq.launch``: ``kernels/chain_kernel.chain_frame`` and
``chain_frames_multi``, up to the launch's enqueue by ``kernels/_build.launch``)."""

from sqbench.layer_metrics import _spans


def read(ctx):
    return _spans.idle_ms_per_record(ctx, "sq.launch")
