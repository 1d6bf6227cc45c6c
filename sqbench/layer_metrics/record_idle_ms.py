"""Device idle ms a record while the host was in ``runtime.run_chain``'s
record (span ``sq.record``: the correlator, the readbacks, the sink and its
callback)."""

from sqbench.layer_metrics import _spans


def read(ctx):
    return _spans.idle_ms_per_record(ctx, "sq.record")
