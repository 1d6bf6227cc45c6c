"""The least time a launch of a 2-D field kernel (kernels 3 and 4) could take
on the card, from the work counts in ``roofline/<kernel>.json`` and
``roofline/noise/<rng_impl>.json`` and a field cell's sizes, against the
card's rates in ``peaks.json``: the field's counterpart of ``work.py``, whose
operation classes, files and bounds it shares.

A field kernel's work comes a site-update (the stencil, the step, the
detector, the observables' sums, the action's force, half a noise
evaluation), a lattice row and a chain each micro-step (the slice
correlator, the chain's means and detector), and a row and a chain each
frame (the epilogue, where the kernel runs it)."""

from __future__ import annotations

import math

from sqbench import work


def launch_work(name: str, cfg: dict, counts: dict) -> tuple[dict, float]:
    """({class: operations}, bytes) of one launch of kernel ``name`` for a
    field cell of configuration ``cfg`` (``shape``, ``n_chains``, ``loops``,
    ``rng_impl``, ``frames_per_launch``); ``counts`` is the configuration's
    own work (the action's force)."""
    k = work.kernel(name)
    noise = work._load("roofline", "noise", f"{cfg['rng_impl']}.json")
    frames = cfg["frames_per_launch"] if k["frames_per_launch"] == "config" else 1
    c, loops = cfg["n_chains"], cfg["loops"]
    L0 = cfg["shape"][0]
    sites = math.prod(cfg["shape"])
    ops, by = k["ops"], k["bytes"]
    noise_site = work._scaled(noise["per_evaluation"],
                              1.0 / noise["site_updates_per_evaluation"])
    site = work._sum(*ops["site_update"].values(), counts["force_per_site_update"], noise_site)
    step = work._sum(work._scaled(site, sites), work._scaled(ops["row_step"], L0),
                     ops["chain_step"])
    frame = work._sum(work._scaled(step, loops), work._scaled(ops["row_frame"], L0),
                      ops["chain_frame"])
    n_ops = work._scaled(frame, frames * c)
    unknown = set(n_ops) - set(work.CLASSES)
    if unknown:
        raise ValueError(f"{name}: operations of unknown classes {sorted(unknown)}")
    n_bytes = c * (sites * by["site_launch"] + L0 * by["row_launch"] + by["chain_launch"]
                   + frames * by["chain_frame"])
    return dict(n_ops), n_bytes


def least_seconds(name: str, cfg: dict, counts: dict) -> tuple[float, str]:
    """(least seconds of a launch, what binds it: 'issue', a class or 'bytes')."""
    peaks = work._load("peaks.json")
    rate = peaks["sms"] * peaks["clock_hz"]
    per_clock = peaks["per_sm_clock"]
    n_ops, n_bytes = launch_work(name, cfg, counts)
    bounds = {"issue": sum(n_ops.values()) / (per_clock["issue"] * rate),
              "bytes": n_bytes / peaks["hbm_bytes_per_s"]}
    for cls, count in n_ops.items():
        if cls in per_clock:
            bounds[cls] = count / (per_clock[cls] * rate)
    binds = max(bounds, key=bounds.get)
    return bounds[binds], binds


def roofline_pct(ctx, name: str):
    """A field kernel's least seconds a launch over the mean device seconds of
    its launches in the trace, in per cent; None without a launch."""
    times = ctx.trace.launches(ctx.kernel(name)["match"])
    if not times:
        return None
    least, _ = least_seconds(name, ctx.cell.cfg, ctx.config["work"])
    return 100.0 * least / (sum(times) / len(times))
