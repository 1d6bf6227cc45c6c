"""Device idle ms a record while the host was in ``runtime.run_chain``'s loop
outside every span (the frame epilogue, the metrics' concatenation, the
checkpoint test, the stop poll, wrappers round the frame function).  With
``launch_idle_ms`` and ``record_idle_ms`` it adds up to the window's idle
time a record."""

from sqbench.layer_metrics import _spans


def read(ctx):
    return _spans.idle_ms_per_record(ctx, _spans.LOOP)
