"""Pure-Python codec for the reference's "%a" hex-float checkpoint format
(this package's copy of ``stochquant_tpu.io.reference_fmt``).

Schema (tauhost.c:562-581): N rows of ``xavg| xx0| x| f`` as C "%a" hex
floats, then ``omega``, the accumulated sample count, and ``deltaTau`` (as
"%e").  The reference's own reader parses one character at a time
(tauhost.c:116) and *discards omega on resume* (flaw F4); this reader keeps
everything.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _parse_float(tok: str) -> float:
    tok = tok.strip()
    if tok.lower().startswith(("0x", "-0x")):
        return float.fromhex(tok)
    return float(tok)


def read(path, n_sites: int) -> Dict:
    with open(path) as fh:
        lines = fh.read().splitlines()
    if len(lines) < n_sites + 3:
        raise ValueError(f"{path}: expected {n_sites + 3} lines, found {len(lines)}")
    xavg = np.zeros(n_sites)
    xx0 = np.zeros(n_sites)
    x = np.zeros(n_sites)
    f = np.zeros(n_sites)
    for i in range(n_sites):
        cols = [c for c in lines[i].split("|") if c.strip()]
        xavg[i], xx0[i], x[i], f[i] = (_parse_float(c) for c in cols[:4])
    omega = _parse_float(lines[n_sites].split("|")[0])
    runs = int(lines[n_sites + 1].split("|")[0].strip())
    dtau = _parse_float(lines[n_sites + 2].split("|")[0])
    return dict(xavg=xavg, xx0=xx0, x=x, f=f, omega=omega, runs=runs, dtau=dtau)


def write(path, xavg, xx0, x, f, omega: float, runs: int, dtau: float) -> None:
    """Write in the reference schema (hex floats via ``float.hex`` — strtod
    and the reference's parser both accept the format)."""
    with open(path, "w") as fh:
        for a, b, c, d in zip(xavg, xx0, x, f):
            fh.write(f"{float(a).hex()}| {float(b).hex()}| {float(c).hex()}| {float(d).hex()}\n")
        fh.write(f"{float(omega).hex()}|omega\n")
        fh.write(f"{int(runs)}|N\n")
        fh.write(f"{float(dtau):.17e}|deltaTau\n")
