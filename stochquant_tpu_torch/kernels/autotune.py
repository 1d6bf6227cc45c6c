"""On-card autotuning of the kernels' launch choices (port of
``stochquant_tpu.kernels.autotune``).

The value 0 of ``ChainConfig.block_chains``, ``FieldConfig.tile_rows`` (D >=
3) and ``FieldConfig.exchange_steps`` asks the runtime to pick the value on
the card for the config at hand; the pick is cached per process under the
JAX package's keys, with the card's name in place of the TPU's device kind,
and the runtime records it as the JAX package does (``{"type": "autotune",
...}``), here with each candidate's time and why a candidate was skipped.

* :func:`best_block_chains`: one launch of kernels 1 / 2 covers every chain
  (``chain_kernel.launch_geometry`` lays them out), so there is nothing to
  time: 0 means the launch's own layout, and the record names it.
* :func:`best_tile_rows`: frames of kernel 6 (the D >= 3 pair path, or
  kernel 7 under ``exchange_steps`` > 2) at every dim-0 tile height the
  geometry admits.
* :func:`best_exchange_steps`: frames of the halo runner's chunk path (kernel
  7) on the mesh at every W the chunk geometry admits.

Candidates are timed in turns (one warm call each, then ``_TUNE_REPS`` rounds
over all of them; the card synchronised around each call), and the fastest
by its least time wins.  A candidate is skipped only by its geometry, checked
before any launch; a build or launch that fails on the card raises.  On CPU
tensors no kernel runs: 0 resolves to the kernel path's default untimed, and
the record says so.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from stochquant_tpu_torch.integrators import field as field_mod
from stochquant_tpu_torch.kernels import chain_kernel
from stochquant_tpu_torch.kernels import field_kernel_nd as fknd

__all__ = ["best_block_chains", "best_tile_rows", "best_exchange_steps", "clear_cache",
           "tile_rows_candidates", "exchange_steps_candidates"]

#: process-wide picks: cache key -> the ``autotune`` record of the pick
_CACHE: dict = {}
#: frames per timed call, timed calls per candidate (min of these)
_TUNE_FRAMES = 4
_TUNE_REPS = 3


def clear_cache() -> None:
    _CACHE.clear()


def _kernels_run(device: torch.device) -> bool:
    """Whether the kernels launch on ``device`` (their wrappers run the plain
    versions on CPU tensors, which there is no point in timing)."""
    return device.type == "cuda"


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if _kernels_run(device) else "cpu"


def _settle(key, record: dict) -> dict:
    _CACHE[key] = record
    return record


def _timed_in_turns(runs: dict, device: torch.device) -> dict:
    """Per candidate, the least seconds of ``_TUNE_REPS`` calls after one warm
    call each, the reps taken in turns across the candidates."""
    for run in runs.values():
        run()
    times = {k: [] for k in runs}
    for _ in range(_TUNE_REPS):
        for k, run in runs.items():
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(device)
            times[k].append(time.perf_counter() - t0)
    return {k: min(v) for k, v in times.items()}


def _pick(knob: str, key, times: dict, skipped: dict, default: int, what: str) -> dict:
    record = {"type": "autotune", knob: min(times, key=times.get) if times else default,
              "candidates_ms": {str(k): t * 1e3 for k, t in times.items()},
              "skipped": {str(k): why for k, why in skipped.items()},
              "frames": _TUNE_FRAMES, "reps": _TUNE_REPS}
    if not times:
        record["reason"] = f"no candidate {what} admits this config: the default"
    return _settle(key, record)


def best_block_chains(action, cfg, *, device) -> dict:
    """Chains per block of the launch's own layout (``launch_geometry``): one
    launch of kernels 1 / 2 covers every chain, and the port has no knob to
    tune.  Returns the ``autotune`` record: the pick under ``"block_chains"``
    and the layout (G warps a chain, S sites a lane)."""
    device = torch.device(device)
    key = (cfg.action, cfg.n_sites, cfg.n_chains, cfg.loops, cfg.rng_impl, int(cfg.scheme),
           int(cfg.formulation), int(cfg.bc), not _kernels_run(device), None, _device_kind(device))
    if key in _CACHE:
        return _CACHE[key]
    G, S, cpb = chain_kernel.launch_geometry(cfg.n_sites, cfg.n_chains)
    record = {"type": "autotune", "block_chains": cpb,
              "launch_geometry": {"warps_per_chain": G, "sites_per_lane": S,
                                  "chains_per_block": cpb},
              "reason": "one launch covers every chain in launch_geometry's layout; "
                        "nothing to time" + ("" if _kernels_run(device) else
                                             " (and no kernel runs on CPU tensors)")}
    return _settle(key, record)


def tile_rows_candidates(cfg, candidates=None):
    """(the dim-0 tile heights whose geometry kernels 6 / 7 admit, {skipped:
    why}) for an unsplit D >= 3 lattice; default candidates: the divisors of
    L0."""
    L0, D = cfg.shape[0], cfg.ndim
    C = cfg.n_chains
    cands = list(candidates) if candidates else [t for t in range(1, L0 + 1) if L0 % t == 0]
    W = cfg.exchange_steps
    chunk = bool(W and W > 2 and cfg.loops % 2 == 0)
    admitted, skipped = [], {}
    for t in cands:
        try:
            if L0 % t:
                raise ValueError(f"tile_rows={t} does not divide the dim-0 extent {L0}")
            fknd._geometry(cfg, cfg.shape, (0,) * D, (0,) * D, 2, C, t)
            if chunk:
                fknd.chunk_geometry(cfg, C, cfg.shape, min(W, cfg.loops),
                                    (True,) + (False,) * (D - 1), tile_rows=t)
        except ValueError as e:
            skipped[t] = str(e)
            continue
        admitted.append(t)
    return admitted, skipped


def best_tile_rows(action, cfg, *, device, candidates=None) -> dict:
    """The fastest dim-0 ``tile_rows`` of kernel 6 (kernel 7 under
    ``exchange_steps`` > 2) for this D >= 3 config on ``device``: frames of
    ``run_field_frames_nd`` at every admitted height, in turns.  Returns the
    ``autotune`` record, the pick under ``"tile_rows"``."""
    device = torch.device(device)
    if cfg.ndim < 3:
        raise ValueError("tile_rows autotune covers D >= 3 lattices (the JAX package's rule); "
                         "2-D takes the strip-tiled kernel's default height")
    key = ("T0", cfg.action, cfg.shape, cfg.n_chains, cfg.loops, cfg.rng_impl, int(cfg.sweep),
           cfg.exchange_steps, not _kernels_run(device),
           tuple(candidates) if candidates else None, _device_kind(device))
    if key in _CACHE:
        return _CACHE[key]
    default = fknd.default_tile_rows(cfg)
    if not _kernels_run(device):
        return _settle(key, {"type": "autotune", "tile_rows": default, "reason":
                             "no kernel runs on CPU tensors: the tile rule's default, untimed"})
    admitted, skipped = tile_rows_candidates(cfg, candidates=candidates)
    cfg_t = dataclasses.replace(cfg, tile_rows=None)
    state = field_mod.init_field_state(cfg_t, device=device)
    runs = {t: (lambda t=t: fknd.run_field_frames_nd(state, action, cfg_t, _TUNE_FRAMES,
                                                     tile_rows=t)) for t in admitted}
    return _pick("tile_rows", key, _timed_in_turns(runs, device), skipped, default, "height")


def _chunk_refusal(action, cfg, mesh):
    """Why the halo runner's chunk path (``cuda_pair``: kernel 7) does not
    admit ``cfg.exchange_steps`` on this split, or None: the checks the
    runner makes before its first launch."""
    from stochquant_tpu_torch.parallel import halo
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    W = cfg.exchange_steps
    if W % 2 or W < 2:
        return f"the chunk kernel advances an even number of steps, not W={W}"
    if W > cfg.loops:
        return f"W={W} exceeds loops={cfg.loops}: its chunks are those of W={cfg.loops}"
    try:
        halo.resolve_backend(action, cfg, mesh, "cuda_pair")
        sizes, local_shape, c_local, _, _ = mesh_mod.split_geometry(cfg, mesh)
        split = (tuple(n > 1 for n in sizes) if any(n > 1 for n in sizes)
                 else (bool(cfg.mesh_axes[0]),) + (False,) * (cfg.ndim - 1))
        for Wx in (W, cfg.loops % W):
            if Wx:
                fknd.chunk_geometry(cfg, c_local, local_shape, Wx, split)
    except ValueError as e:
        return str(e)
    return None


def exchange_steps_candidates(action, cfg, mesh, candidates=None):
    """(the W the chunk path admits on this split, {skipped: why}); default
    candidates (2, 4, 8, 16), in 2-D also 32 and 64."""
    if candidates is None:
        candidates = (2, 4, 8, 16, 32, 64) if cfg.ndim == 2 else (2, 4, 8, 16)
    admitted, skipped = [], {}
    for W in candidates:
        why = _chunk_refusal(action, dataclasses.replace(cfg, exchange_steps=int(W)), mesh)
        if why:
            skipped[int(W)] = why
        else:
            admitted.append(int(W))
    return admitted, skipped


def best_exchange_steps(action, cfg, mesh, *, candidates=None) -> dict:
    """The fastest ``exchange_steps`` (W) of the halo runner's chunk path on
    ``mesh``: ``_TUNE_FRAMES`` frames of the runner at every admitted W, in
    turns (a wider W can lose end to end: at 32^4 x 1 on an H100, W = 4 ran
    below the pair path, PERF.md §6).  Returns the ``autotune`` record, the
    pick under ``"exchange_steps"``."""
    from stochquant_tpu_torch.parallel import halo
    from stochquant_tpu_torch.parallel import mesh as mesh_mod

    if candidates is None:
        candidates = (2, 4, 8, 16, 32, 64) if cfg.ndim == 2 else (2, 4, 8, 16)
    device = mesh.devices[0]
    key = ("W", cfg.action, cfg.shape, cfg.n_chains, cfg.loops, cfg.rng_impl, int(cfg.sweep),
           cfg.mesh_axes, cfg.mesh_chain_axis, tuple(mesh.shape), not _kernels_run(device),
           tuple(candidates), _device_kind(device))
    if key in _CACHE:
        return _CACHE[key]
    default = fknd.default_exchange_steps(cfg)
    if not _kernels_run(device):
        return _settle(key, {"type": "autotune", "exchange_steps": default, "reason":
                             "no kernel runs on CPU tensors: the per-dimension default, untimed"})
    admitted, skipped = exchange_steps_candidates(action, cfg, mesh, candidates)
    shards = mesh_mod.shard_field_state(field_mod.init_field_state(cfg, device=device), mesh, cfg)
    runs = {}
    for W in admitted:
        runner = halo.make_halo_runner(action, dataclasses.replace(cfg, exchange_steps=W), mesh,
                                       backend="cuda_pair")
        runs[W] = lambda runner=runner: runner(shards, _TUNE_FRAMES)
    return _pick("exchange_steps", key, _timed_in_turns(runs, device), skipped, default, "W")
