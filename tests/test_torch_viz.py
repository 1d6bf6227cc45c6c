"""The port's metrics-tail client and live plot (``stochquant_tpu_torch.viz``):
the five cases of ``tests/test_viz.py``, each also held against the JAX
package's ``viz`` on the same file (the same records, the same line data and
status text).  Tolerances: none."""

import json

import numpy as np

from stochquant_tpu import viz as jviz
from stochquant_tpu_torch import viz
from stochquant_tpu_torch.viz import MetricsTail


def _frame(i, n=4):
    return json.dumps({"type": "frame", "frame": i, "percent": 100.0 * (i + 1) / 10,
                       "dtau": 0.01, "log_abs_corr": [float(i)] * n})


def _both(path):
    return MetricsTail(str(path)), jviz.MetricsTail(str(path))


def test_metrics_tail_polls_incrementally(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text(_frame(0) + "\n" + _frame(1) + "\n")
    tail, jtail = _both(p)
    with tail, jtail:
        rec = tail.poll()
        assert rec["frame"] == 1 and rec == jtail.poll()  # the newest complete frame wins
        assert tail.poll() is None and jtail.poll() is None
        with open(p, "a") as fh:
            fh.write(_frame(2) + "\n")
        assert tail.poll()["frame"] == 2 == jtail.poll()["frame"]


def test_metrics_tail_tolerates_partial_lines(tmp_path):
    p = tmp_path / "m.jsonl"
    partial = _frame(1)
    p.write_text(_frame(0) + "\n" + partial[: len(partial) // 2])
    tail, jtail = _both(p)
    with tail, jtail:
        assert tail.poll()["frame"] == 0 == jtail.poll()["frame"]
        with open(p, "a") as fh:
            fh.write(partial[len(partial) // 2:] + "\n")
        assert tail.poll()["frame"] == 1 == jtail.poll()["frame"]


def test_metrics_tail_skips_non_frame_records(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text(json.dumps({"type": "summary", "avg_mlups": 1.0}) + "\n"
                 + json.dumps({"type": "autotune", "tile_rows": 8}) + "\n" + _frame(3) + "\n")
    tail, jtail = _both(p)
    with tail, jtail:
        assert tail.poll() == jtail.poll() and tail._fh.tell() == jtail._fh.tell()


def test_metrics_tail_close_releases_handle(tmp_path):
    p = tmp_path / "m.jsonl"
    p.write_text(_frame(0) + "\n")
    tail = MetricsTail(str(p))
    tail.poll()
    tail.close()
    assert tail._fh.closed


def test_live_plot_animation_updates_line_headless(tmp_path):
    """Drive the animation's update closure on the Agg backend, beside the
    JAX package's: the line and status text follow the newest frame."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    p = tmp_path / "m.jsonl"
    p.write_text(_frame(0) + "\n")
    update, jupdate = viz.live_plot(str(p), show=False)._func, jviz.live_plot(str(p), show=False)._func
    (ln, txt), (jln, jtxt) = update(0), jupdate(0)
    np.testing.assert_array_equal(ln.get_ydata(), [0.0] * 4)
    assert "10.0%" in txt.get_text() and "1.00e-02" in txt.get_text()
    assert txt.get_text() == jtxt.get_text()
    with open(p, "a") as fh:
        fh.write(_frame(1) + "\n" + _frame(2) + "\n")
    (ln, txt), (jln, jtxt) = update(1), jupdate(1)
    np.testing.assert_array_equal(ln.get_ydata(), [2.0] * 4)
    np.testing.assert_array_equal(ln.get_xdata(), range(4))
    np.testing.assert_array_equal(ln.get_ydata(), jln.get_ydata())
    assert "30.0%" in txt.get_text() and txt.get_text() == jtxt.get_text()
    ln, txt = update(2)  # nothing new: the artists keep their last state
    np.testing.assert_array_equal(ln.get_ydata(), [2.0] * 4)
    plt.close("all")


def test_cli_plot_follows_a_run_headless(tmp_path, monkeypatch):
    """``cli plot --follow`` on a metrics file the port's ``cli run`` wrote."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from stochquant_tpu_torch import cli

    m = tmp_path / "run.jsonl"
    cli.main(["run", "--preset", "harmosc", "--device", "cpu", "--frames", "2", "--loops", "5",
              "--chains", "2", "--dtau", "1e-3", "--metrics", str(m)])
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(plt.gcf()))
    cli.main(["plot", "--follow", str(m)])
    assert len(shown) == 1
    plt.close("all")
