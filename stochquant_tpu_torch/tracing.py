"""Spans of the host loop, written into a running ``torch.profiler`` trace.

``span(name)`` is a context manager around a part of the host's work.  While
a profiler records (``cli run --profile``, a traced benchmark run), entering
the span writes a zero-length marker named ``name`` and leaving it one named
``name + END``: host events of the kind ``torch.profiler.record_function``
writes, without the dispatcher's op around it (``_RecordFunctionFast``, at a
fraction of the cost).  The pair brackets the part on the host's clock, onto
which the profiler maps the device's operations too, so a reader of the trace
can tell what the host was doing while the device idled (that mapping can be
off by milliseconds on a card: ``sqbench/layer_metrics/_spans.py`` aligns it
at each kernel launch).  The loop is one thread and sequential, so the order
of the markers gives each span's extent and nesting.  When no profiler
records, ``span`` returns one shared no-op: the cost is one check.

Markers, not ranges: a ``record_function`` range that encloses CUDA work
makes the profiler add a device-side ``gpu_user_annotation`` event of the same
name over the kernels launched inside it, which a reader of the device's
operations would count as device time.  A zero-length marker encloses no
CUDA call and gets no such event.

The spans (``PERF.md`` names the metrics that read them):

* ``sq.launch`` — a kernel wrapper: the chain kernels' (1 and 2),
  ``kernels.chain_kernel.chain_frame`` and ``chain_frames_multi``, and the
  2-D field kernels' (3 and 4), ``kernels.field_kernel.field_frame`` and
  ``field_frames_multi``: the config check, the inputs' check, the launch
  parameters and geometry, the output allocations and the launch up to its
  enqueue.
* ``sq.record`` — a streamed record.  Of ``runtime.run_chain``, read one
  frame group late: the wait on the group's event (its correlator, Δτ row and
  stable share copied to the host), the host-side numpy and the sink with
  its callback; the record's device work and copies are enqueued outside
  the span, right after the group.  Of ``runtime.run_field``, read at once:
  the observables' means and their reductions, the seven blocking copies to
  the host (five observables, the Δτ row, the stable share), the host-side
  numpy and the sink with its callback.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["END", "LAUNCH", "RECORD", "span"]

LAUNCH = "sq.launch"
RECORD = "sq.record"
#: suffix of the marker that closes a span
END = "/end"

_OFF = contextlib.nullcontext()


def _mark(name: str) -> None:
    with _RecordFunctionFast(name):
        pass


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _mark(self.name)
        return self

    def __exit__(self, *exc):
        _mark(self.name + END)
        return False


def span(name: str):
    """A span named ``name``: two markers while a profiler records, else the
    shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)
