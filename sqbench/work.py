"""The least time a kernel launch could take on the card, from the work counts
in ``roofline/<kernel>.json`` and ``roofline/noise/<rng_impl>.json`` and the
cell's sizes, against the card's rates in ``peaks.json``.

Operations are counted by class: ``fp32`` (float32 add, multiply, fused
multiply-add), ``alu`` (shifts, rotates, logic, compares, min, max, selects),
``sfu`` (log2, square root, sine, cosine, tanh, reciprocal) and ``iadd``
(integer adds, which the compiler may put on the integer or the FMA pipe, so
they have no pipe bound of their own).  The least time is the largest of:
every operation at the SMs' issue rate, each class at its pipe's rate, and
the bytes at the memory's rate."""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
CLASSES = ("fp32", "alu", "sfu", "iadd")


def _load(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def kernel(name: str) -> dict:
    return _load("roofline", f"{name}.json")


def _scaled(counts: dict, k: float) -> Counter:
    return Counter({c: k * n for c, n in counts.items()})


def _sum(*counts) -> Counter:
    total = Counter()
    for c in counts:
        total.update(c)
    return total


def launch_work(name: str, cfg: dict, work: dict) -> tuple[dict, float]:
    """({class: operations}, bytes) of one launch of kernel ``name`` for a
    chain cell of configuration ``cfg``; ``work`` is the configuration's own
    counts (the action's force, whether it has a collective coordinate)."""
    k = kernel(name)
    noise = _load("roofline", "noise", f"{cfg['rng_impl']}.json")
    frames = cfg["frames_per_launch"] if k["frames_per_launch"] == "config" else 1
    c, n, loops = cfg["n_chains"], cfg["n_sites"], cfg["loops"]
    ops, by = k["ops"], k["bytes"]
    noise_site = _scaled(noise["per_evaluation"], 1.0 / noise["site_updates_per_evaluation"])
    site = _sum(*ops["site_update"].values(), work["force_per_site_update"], noise_site)
    chain = _sum(ops["collective_step"], noise_site) if work["collective_coordinate"] else {}
    frame = _sum(_scaled(site, loops * n), _scaled(chain, loops),
                 _scaled(ops["site_frame"], n), ops["chain_frame"])
    n_ops = _scaled(frame, frames * c)
    unknown = set(n_ops) - set(CLASSES)
    if unknown:
        raise ValueError(f"{name}: operations of unknown classes {sorted(unknown)}")
    n_bytes = c * (n * by["site_launch"] + by["chain_launch"] + frames * by["chain_frame"])
    return dict(n_ops), n_bytes


def least_seconds(name: str, cfg: dict, work: dict) -> tuple[float, str]:
    """(least seconds of a launch, what binds it: 'issue', a class or 'bytes')."""
    peaks = _load("peaks.json")
    rate = peaks["sms"] * peaks["clock_hz"]
    per_clock = peaks["per_sm_clock"]
    n_ops, n_bytes = launch_work(name, cfg, work)
    bounds = {"issue": sum(n_ops.values()) / (per_clock["issue"] * rate),
              "bytes": n_bytes / peaks["hbm_bytes_per_s"]}
    for cls, count in n_ops.items():
        if cls in per_clock:
            bounds[cls] = count / (per_clock[cls] * rate)
    binds = max(bounds, key=bounds.get)
    return bounds[binds], binds
