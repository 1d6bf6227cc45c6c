"""Chain cells: an ensemble of 1-D Langevin chains served by the port's
``runtime.run_chain``, its records streamed every ``fps`` frames.

The harness gives ``run_chain`` its configuration, a sink and a ``stop``
and runs nothing of the loop itself.  To judge what the timed path produced,
:class:`Observer` sits between ``run_chain`` and the frame function it calls
(``kernels.chain_kernel.run_frames_kernel`` on the card, the plain
``integrators.langevin.run_frames`` on the CPU): it passes every call through
unchanged and copies the sampled chains' rows of a few calls, drawn from the
seed, into slots it allocated in set-up.  The last record is kept with the
program's final state, which ``run_chain`` returns.

After the window the plain reference (``sqbench/reference/chain.py``)
follows the sampled chains: from the seed itself through the cold start and
the burn-in, and from the program's own input rows through each kept call.
It compares three layers of ``run_chain``: the kernels' state (field, ω,
running means, detector maxima), the epilogue's decisions (stable, Δτ,
counters, the sample count) and the streamed record (``log_abs_corr``,
against the program's final state over all chains).
"""

from __future__ import annotations

import numpy as np
import torch

from sqbench.reference import chain as ref

#: leaves of the program's state the harness copies for the check
_LEAVES = ref.FLOAT_LEAVES + ref.EXACT_LEAVES
#: per-frame metrics of a call the check compares
_METRICS = ("stable", "dtau")


def _int_seed(seed: int) -> int:
    """A seed for numpy's generator from the run's seed (any size)."""
    return int(seed) & (2**63 - 1)


class Observer:
    """Passes each call of the frame function through and copies the rows
    ``rows`` of its input state, output state and per-frame metrics for call 0
    (the burn-in), call 1 (the group whose record opens the window) and
    ``keep`` window calls drawn by reservoir sampling.  Calls 0 and 1 run in
    set-up: they allocate their own copies, and call 1 allocates the window's
    ``keep`` slots beside its own, so that a window call copies into a slot
    with ``index_select(..., out=)`` and allocates nothing."""

    def __init__(self, keep: int, rng: np.random.Generator, rows: torch.Tensor):
        self.keep, self.rng, self.rows = keep, rng, rows
        self.calls = 0
        self.kept = {}          # call index -> slot
        self.free = []          # window slots not in use
        self.reservoir = []     # kept window call indices

    def wrap(self, fn):
        def observed(state, *args, **kw):
            out, m = fn(state, *args, **kw)
            self._saw(state, out, m)
            return out, m
        return observed

    def _saw(self, state, out, m):
        i, self.calls = self.calls, self.calls + 1
        if i < 2:
            self.kept[i] = _copy(state, out, m, self.rows)
            if i == 1:
                self.free = [_empty_like(self.kept[1]) for _ in range(self.keep)]
            return
        if len(self.reservoir) < self.keep:
            slot = self.free.pop()
            self.reservoir.append(i)
        else:
            j = int(self.rng.integers(i - 1))
            if j >= self.keep:
                return
            slot = self.kept.pop(self.reservoir[j])
            self.reservoir[j] = i
        _copy(state, out, m, self.rows, slot)
        self.kept[i] = slot

    def window_calls(self) -> int:
        return len(self.reservoir)


def _copy(state, out, m, rows, slot=None) -> dict:
    """The rows of a call's states and metrics, copied into ``slot`` (a new
    one where None)."""
    def take(src, dim, dst):
        if dst is None:
            return torch.index_select(src, dim, rows)
        return torch.index_select(src, dim, rows, out=dst)

    new = slot is None
    slot = slot or {"in": {}, "out": {}, "metrics": {}}
    for side, s in (("in", state), ("out", out)):
        for k in _LEAVES:
            slot[side][k] = take(getattr(s, k), 0, None if new else slot[side][k])
        slot[side + "_step"] = int(s.step)
    for k in _METRICS:
        slot["metrics"][k] = take(m[k], 1, None if new else slot["metrics"][k])
    slot["frames"] = int(m["stable"].shape[0])
    return slot


def _empty_like(slot: dict) -> dict:
    return {side: {k: torch.empty_like(v) for k, v in slot[side].items()}
            for side in ("in", "out", "metrics")}


class Cell:
    """One chain cell: its configuration, traffic and check, for one seed."""

    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        if traffic["burn_frames"] < 1:
            raise ValueError("a chain cell burns in at least one frame: the check starts there")
        self.traffic = traffic
        self.check_spec = cell["check"]
        c = dict(config["chain"])
        for key in ("rng_impl", "frames_per_launch", "fps"):
            c[key] = traffic[key]
        c["seed"] = self.seed
        self.cfg = dict(c, action_params=config.get("action_params", {}))
        self.n_chains, self.n_sites = c["n_chains"], c["n_sites"]
        self.fps = c["fps"]
        #: lattice updates (sites) and chain-frames a record stands for
        self.updates_per_record = self.n_chains * self.n_sites * c["loops"] * self.fps
        self.chain_frames_per_record = self.n_chains * self.fps
        self.rows = self._sample()
        self.observer = Observer(self.check_spec["calls"],
                                 np.random.default_rng(_int_seed(seed)), self.rows)
        self.final_state = self.last_record = None

    def program_config(self):
        """The program's ``ChainConfig``.  The program runs its action with
        the action's own parameters: they have to be the ones the reference
        is given (``action_params``)."""
        from stochquant_tpu_torch import actions
        from stochquant_tpu_torch.config import (
            BoundaryCondition, ChainConfig, Formulation, Scheme,
        )
        act = actions.get(self.cfg["action"])
        for k, v in self.cfg["action_params"].items():
            if getattr(act, k) != v:
                raise ValueError(f"action_params[{k!r}] = {v!r}, but the program's "
                                 f"{self.cfg['action']} action has {getattr(act, k)!r}")
        c = {k: v for k, v in self.cfg.items() if k != "action_params"}
        c["bc"] = BoundaryCondition[c["bc"]]
        c["formulation"] = Formulation[c["formulation"]]
        c["scheme"] = Scheme[c["scheme"]]
        if c.get("ghost_override") is not None:
            c["ghost_override"] = tuple(c["ghost_override"])
        c["frames"] = 2**62  # the window's stop ends the run
        return ChainConfig(**c)

    def failed(self, rec: dict) -> int:
        """Chain-frames of a record that the divergence detector rejected."""
        return int(round((1.0 - rec["stable_frac"]) * self.chain_frames_per_record))

    def serve(self, on_record, stop) -> None:
        """Run the window: ``run_chain`` until ``stop()``; ``on_record(rec)``
        sees each streamed frame record as it arrives."""
        from stochquant_tpu_torch import metrics, runtime
        from stochquant_tpu_torch.integrators import langevin
        from stochquant_tpu_torch.kernels import chain_kernel

        cuda = self.device.type == "cuda"
        module, name = (chain_kernel, "run_frames_kernel") if cuda else (langevin, "run_frames")

        def callback(rec):
            if rec.get("type") == "frame":
                self.last_record = rec.get("log_abs_corr")
                on_record(rec)

        cfg = self.program_config()
        original = getattr(module, name)
        setattr(module, name, self.observer.wrap(original))
        try:
            result = runtime.run_chain(
                cfg, device=self.device, backend="cuda" if cuda else "torch",
                burn_frames=self.traffic["burn_frames"],
                sink=metrics.MetricsSink(callback=callback), stop=stop,
                stream_correlator=True)
        finally:
            setattr(module, name, original)
        self.final_state = result.state

    # ------------------------------------------------------------------
    # the check
    # ------------------------------------------------------------------

    def _sample(self) -> torch.Tensor:
        rng = np.random.default_rng(_int_seed(self.seed) ^ 0x5EED)
        n = min(self.n_chains, self.check_spec["chains"])
        rows = np.sort(rng.choice(self.n_chains, size=n, replace=False))
        return torch.as_tensor(rows, dtype=torch.int64, device=self.device)

    def prepare_check(self, control_dtype=torch.bfloat16) -> None:
        """Read the last record's correlator from the program's final state
        over every chain, in float32 and in ``control_dtype``, and let the
        state go, so that the reference runs in the memory it held."""
        obs = self.observer
        self.window_calls = obs.window_calls()
        self.checks = [_item(i, obs.kept[i]) for i in sorted(obs.kept)]
        self.record = None
        if self.last_record is not None and self.final_state is not None:
            self.record = {"log_abs_corr": np.asarray(self.last_record, dtype=np.float64),
                           "corr": {dt: _mean_correlator(self.final_state, dt)
                                    for dt in (torch.float32, control_dtype)}}
        self.graphs = ref.Graphs()
        self.observer = self.final_state = None

    def check(self, dtype=torch.float32) -> dict:
        """The readings: ``state_gap`` (largest gap of a float leaf over the
        sampled chains, as a share of the leaf's largest magnitude),
        ``decisions`` (sampled chains and chain-frames whose stable flag, Δτ,
        counter, sample count or step differ), ``record_gap`` (gap of the last
        record's |correlator| from the one the program's final state gives
        over all chains, as a share of its largest magnitude) and ``missing``
        (what the check has to see and did not: the burn-in, the call that
        opens the window, a window call, the last record).

        Call 0 (the burn-in) is followed from the seed: the cold start, its
        frames, then the reset of the running means against the input of
        call 1.  Every other kept call is followed from the program's own
        input rows.  ``dtype`` below float32 puts the reference in the
        program's place at that precision: the control."""
        rows, cfg = self.rows, self.cfg
        control = dtype != torch.float32
        calls = {item["call"] for item in self.checks}
        missing = ((0 not in calls) + (1 not in calls) + (self.window_calls == 0)
                   + (self.record is None))
        state_gap, decisions, record_gap = 0.0, 0, 0.0
        burned = None
        for item in self.checks:
            if item["call"] == 0:
                start = ref.init_state(cfg, rows)
                state_gap = max(state_gap, _state_gap(item["in"], start))
                decisions += _decisions(item["in"], start)
            else:
                start = item["in"]
                if item["call"] == 1 and burned is not None:
                    reset = ref.reset_means(burned)
                    state_gap = max(state_gap, _state_gap(start, reset))
                    decisions += _decisions(start, reset)
            want, want_m = ref.frames(start, cfg, rows, item["frames"], self.graphs)
            if control:
                got, got_m = ref.frames(_cast(start, dtype), cfg, rows, item["frames"],
                                        self.graphs)
                got = _cast(got, torch.float32)
                got_m = {k: v.float() if v.is_floating_point() else v for k, v in got_m.items()}
            else:
                got, got_m = item["out"], item["metrics"]
            if item["call"] == 0:
                burned = want
            state_gap = max(state_gap, _state_gap(got, want))
            decisions += _decisions(got, want, got_m, want_m)
        if self.record is not None:
            corr = self.record["corr"]
            got_rec = corr[dtype] if control else np.exp(self.record["log_abs_corr"])
            record_gap = _gap(got_rec, np.abs(corr[torch.float32]))
        return {"state_gap": state_gap, "decisions": decisions, "record_gap": record_gap,
                "missing": missing}


def _item(call: int, slot: dict) -> dict:
    """A kept call as the check reads it: its input and output rows as
    reference states, its metrics and its frames."""
    return {"call": call, "frames": slot["frames"], "metrics": slot["metrics"],
            "in": ref.State(**slot["in"], step=slot["in_step"]),
            "out": ref.State(**slot["out"], step=slot["out_step"])}


def _cast(state: ref.State, dtype) -> ref.State:
    return state._replace(**{k: getattr(state, k).to(dtype)
                             for k in ref.FLOAT_LEAVES + ("dtau",)})


def _mean_correlator(state, dtype) -> np.ndarray:
    """|⟨connected correlator⟩| over every chain, computed in ``dtype``."""
    corr = ref.connected_correlator(state.x_mean.to(dtype), state.xx0_mean.to(dtype))
    return np.abs(corr.mean(dim=0).double().cpu().numpy())


def _gap(got, want) -> float:
    """max |got - want| over max |want| (the plain gap where want is all 0)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    d = float(np.max(np.abs(got - want)))
    if not np.isfinite(d):
        return float("inf")
    scale = float(np.max(np.abs(want)))
    return d / scale if scale > 0 else d


def _state_gap(got: ref.State, want: ref.State) -> float:
    return max(_gap(getattr(got, k).double().cpu().numpy(),
                    getattr(want, k).double().cpu().numpy()) for k in ref.FLOAT_LEAVES)


def _decisions(got: ref.State, want: ref.State, got_m=None, want_m=None) -> int:
    """Chains whose exact leaves differ, plus chain-frames whose stable flag
    or Δτ differ."""
    bad = torch.zeros(got.f.shape[0], dtype=torch.bool)
    for k in ref.EXACT_LEAVES:
        g, w = getattr(got, k).cpu(), getattr(want, k).cpu()
        bad |= (g != w).reshape(g.shape[0], -1).any(dim=-1)
    n = int(bad.sum()) + (got.step != want.step) * got.f.shape[0]
    if got_m is not None:
        n += sum(int((got_m[k].cpu() != want_m[k].cpu()).sum()) for k in ("stable", "dtau"))
    return n
