"""Device idle ms a record while the host was in ``runtime.run_field``'s
record (span ``sq.record``: the observables' means, the seven blocking
readbacks, the host-side numpy, the sink and its callback), the clocks
aligned at the field kernels' launches (``_field_spans.py``)."""

from sqbench.layer_metrics import _field_spans


def read(ctx):
    return _field_spans.idle_ms_per_record(ctx, "sq.record")
