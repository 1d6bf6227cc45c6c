"""The card beside a run: its name and power limit, the SM clock range while
the window runs, and a synchronised timer.  Frozen copies of ``chip_smoke.py``'s
``card_line``, ``CardSampler`` and ``timed``, kept here so that the yardstick
does not move with the program's scripts."""

from __future__ import annotations

import subprocess
import time


def card_line() -> str:
    """'<name>, <power limit>' from nvidia-smi, or 'unknown' without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0]


class CardSampler:
    """Samples the card's SM clock, power draw and temperature once a second
    (``nvidia-smi -lms``) while the window runs; :meth:`stop` returns their
    range: the same binary runs slower on a card that is clocked down, so a
    time is only read beside the clock it was taken at."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits", "-lms", "1000"]

    def __init__(self):
        try:
            self.proc = subprocess.Popen(self.QUERY, stdout=subprocess.PIPE,
                                         stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> str:
        if self.proc is None:
            return "nvidia-smi unavailable"
        self.proc.terminate()
        try:
            text, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            text, _ = self.proc.communicate()
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return "no samples"
        mhz, watts, temp = (sorted(col) for col in zip(*rows))
        return (f"SM clock {mhz[0]:.0f}-{mhz[-1]:.0f} MHz (median {mhz[len(mhz) // 2]:.0f}), "
                f"power {watts[0]:.1f}-{watts[-1]:.1f} W, {temp[0]:.0f}-{temp[-1]:.0f} C "
                f"over {len(rows)} samples")


def timed(torch, fn) -> float:
    """Seconds of ``fn()`` with the device synchronised before and after."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter() - t0
