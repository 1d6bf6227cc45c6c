"""Device idle ms a record while the host was in a 2-D field kernel's wrapper
(span ``sq.launch``: ``kernels/field_kernel.field_frame`` and
``field_frames_multi``, up to the launch's enqueue by ``kernels/_build.launch``),
the clocks aligned at the field kernels' launches (``_field_spans.py``)."""

from sqbench.layer_metrics import _field_spans


def read(ctx):
    return _field_spans.idle_ms_per_record(ctx, "sq.launch")
