"""Live plot of a run's metrics stream (port of ``stochquant_tpu.viz``):
capability parity with the reference's matplotlib animation
(``taumain.py:51-89``), reading the JSON-lines records instead of a
'|'-delimited stdout pipe.

The simulation writes its records to a file (``cli run --metrics run.jsonl``)
and any number of plot clients tail it (``cli plot --follow run.jsonl``).
"""

from __future__ import annotations

import json


class MetricsTail:
    """Incremental reader of a metrics .jsonl file: each ``poll()`` returns
    the newest complete ``frame`` record carrying a correlator (or None),
    tolerating a partly written last line.  A context manager, so the file
    handle is released when the caller is done."""

    def __init__(self, path: str):
        self._fh = open(path)

    def poll(self):
        last = None
        while True:
            pos = self._fh.tell()
            line = self._fh.readline()
            if not line:
                break
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # a line still being written: rewind so the next poll reads it whole
                self._fh.seek(pos)
                break
            if rec.get("type") == "frame" and "log_abs_corr" in rec:
                last = rec
        return last

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def live_plot(path: str, poll_s: float = 0.5, show: bool = True):
    """Tail a metrics .jsonl file and animate log|C(t)| (the quantity whose
    slope gives the energy gap, streamed by tauhost.c:491).  matplotlib is
    imported here, not with the package."""
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, ax = plt.subplots()
    (ln,) = ax.plot([], [], "ro-", markersize=2)
    txt = ax.text(0.02, 0.95, "", transform=ax.transAxes)
    tail = MetricsTail(path)

    def update(_):
        rec = tail.poll()
        if rec is not None:
            y = rec["log_abs_corr"]
            ln.set_data(range(len(y)), y)
            ax.relim()
            ax.autoscale_view()
            txt.set_text(f"{rec['percent']:.1f}%  Δτ={rec['dtau']:.2e}  "
                         f"{rec.get('mlups', 0):.0f} MLUPS")
        return ln, txt

    ani = animation.FuncAnimation(fig, update, interval=int(poll_s * 1000),
                                  cache_frame_data=False)
    plt.xlabel("site")
    plt.ylabel("log |C(t)|")
    if show:
        try:
            plt.show()
        finally:
            tail.close()
    return ani
