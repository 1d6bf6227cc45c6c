"""Field cells: an ensemble of periodic 2-D λφ⁴ lattices served by the port's
``runtime.run_field``, its records streamed every ``fps`` frames.

The harness gives ``run_field`` its configuration, ``backend="auto"``, a
sink and a ``stop`` and runs nothing of the loop itself.  To judge what the
timed path produced, :class:`Observer` sits between ``run_field`` and the
frame function it calls (``kernels.field_kernel.run_field_frames_kernel`` on
the card, kernels 3 and 4; the plain ``integrators.field.run_field_frames``
on the CPU): it passes every call through unchanged and copies the sampled
chains' rows of a few calls, drawn from the seed, into slots it allocated in
set-up.  The last record is kept with the program's final state, which
``run_field`` returns.

After the window the plain reference (``sqbench/reference/field.py``)
follows the sampled chains: from the seed itself through the cold start and
the burn-in, and from the program's own input rows through each kept call.
It compares three layers of ``run_field``: the kernels' state (the field,
the running means, the slice correlator, the detector's maxima), the
epilogue's decisions (stable, Δτ, counters, the sample count, the step) and
the streamed record (its five observables, against those the program's
final state gives over every chain).

The configuration's ``chain`` holds the ensemble's settings, the port's
``FieldConfig`` fields (``run.py`` applies a test's overrides there; a
chain cell's ``n_sites`` there sizes a square lattice of that side).
"""

from __future__ import annotations

import numpy as np
import torch

from sqbench.kinds.chain import Observer as _ChainObserver
from sqbench.kinds.chain import _gap, _int_seed
from sqbench.reference import field as ref

#: leaves of the program's state the harness copies for the check
_LEAVES = ref.FLOAT_LEAVES + ref.EXACT_LEAVES
#: per-frame metrics of a call the check compares
_METRICS = ("stable", "dtau")


class Observer(_ChainObserver):
    """The chain kind's observer (calls 0 and 1 copied in set-up, ``keep``
    window calls by reservoir sampling into slots allocated at call 1), with
    a field state's leaves."""

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
    """One field cell: its configuration, traffic and check, for one seed."""

    def __init__(self, config: dict, traffic: dict, cell: dict, seed: int, device):
        self.device = torch.device(device)
        self.seed = int(seed)
        if traffic["burn_frames"] < 1:
            raise ValueError("a field cell burns in at least one frame: the check starts there")
        self.traffic = traffic
        self.check_spec = cell["check"]
        c = dict(config["chain"])
        for key in ("rng_impl", "frames_per_launch", "fps"):
            c[key] = traffic[key]
        c["seed"] = self.seed
        # a chain cell's size key, as a test sizes every cell: a square lattice of that side
        side = c.pop("n_sites", None)
        c["shape"] = [side, side] if side is not None else list(c["shape"])
        self.cfg = dict(c, action_params=config.get("action_params", {}))
        self.n_chains, self.volume = c["n_chains"], ref.volume(c)
        self.fps = c["fps"]
        #: lattice updates (sites) and chain-frames a record stands for
        self.updates_per_record = self.n_chains * self.volume * c["loops"] * self.fps
        self.chain_frames_per_record = self.n_chains * self.fps
        self.rows = self._sample()
        self.observer = Observer(self.check_spec["calls"],
                                 np.random.default_rng(_int_seed(seed)), self.rows)
        self.final_state = self.last_record = None

    def program_config(self):
        """The program's ``FieldConfig``.  The program runs its action with
        the action's own parameters: they have to be the ones the reference
        is given (``action_params``)."""
        from stochquant_tpu_torch import actions
        from stochquant_tpu_torch.config import FieldConfig, Scheme, Sweep
        act = actions.get_field(self.cfg["action"])
        for k, v in self.cfg["action_params"].items():
            if getattr(act, k) != v:
                raise ValueError(f"action_params[{k!r}] = {v!r}, but the program's "
                                 f"{self.cfg['action']} action has {getattr(act, k)!r}")
        c = {k: v for k, v in self.cfg.items() if k != "action_params"}
        c["shape"] = tuple(c["shape"])
        c["sweep"] = Sweep[c["sweep"]]
        c["scheme"] = Scheme[c["scheme"]]
        c["frames"] = 2**62  # the window's stop ends the run
        return FieldConfig(**c)

    def failed(self, rec: dict) -> int:
        """Chain-frames of a record that the divergence detector rejected."""
        return int(round((1.0 - rec["stable_frac"]) * self.chain_frames_per_record))

    def serve(self, on_record, stop) -> None:
        """Run the window: ``run_field`` until ``stop()``; ``on_record(rec)``
        sees each streamed frame record as it arrives."""
        from stochquant_tpu_torch import metrics, runtime
        from stochquant_tpu_torch.integrators import field as field_mod
        from stochquant_tpu_torch.kernels import field_kernel

        cuda = self.device.type == "cuda"
        module, name = ((field_kernel, "run_field_frames_kernel") if cuda
                        else (field_mod, "run_field_frames"))

        def callback(rec):
            if rec.get("type") == "frame":
                self.last_record = {k: rec.get(k) for k in ref.OBSERVABLES}
                on_record(rec)

        cfg = self.program_config()
        original = getattr(module, name)
        setattr(module, name, self.observer.wrap(original))
        try:
            result = runtime.run_field(
                cfg, device=self.device, backend="auto",
                burn_frames=self.traffic["burn_frames"],
                sink=metrics.MetricsSink(callback=callback), stop=stop)
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
        """Compute the last record's observables from the program's final
        state over every chain, in float32 and in ``control_dtype``, and let
        the state go, so that the reference runs in the memory it held."""
        obs = self.observer
        self.window_calls = obs.window_calls()
        self.checks = [_item(i, obs.kept[i]) for i in sorted(obs.kept)]
        self.record = None
        record_ok = self.last_record is not None and None not in self.last_record.values()
        if record_ok and self.final_state is not None:
            self.record = {"got": {k: float(v) for k, v in self.last_record.items()},
                           "want": {dt: _record_observables(self.final_state, dt, self.volume)
                                    for dt in (torch.float32, control_dtype)}}
        self.graphs = ref.Graphs()
        self.observer = self.final_state = None

    def check(self, dtype=torch.float32) -> dict:
        """The readings: ``state_gap`` (largest gap of a float leaf over the
        sampled chains, as a share of the leaf's largest magnitude),
        ``decisions`` (sampled chains and chain-frames whose stable flag, Δτ,
        counter, sample count or step differ), ``record_gap`` (largest gap of
        one of the last record's five observables from the one the program's
        final state gives over every chain, as a share of the larger of its
        magnitude and the chains' mean magnitude) and ``missing`` (what the
        check has to see and did not: the burn-in, the call that opens the
        window, a window call, the last record).

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
            want = self.record["want"][torch.float32]
            got = ({k: v[0] for k, v in self.record["want"][dtype].items()} if control
                   else self.record["got"])
            record_gap = max(_record_gap(got[k], *want[k]) for k in ref.OBSERVABLES)
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


def _record_observables(state, dtype, volume: int) -> dict:
    """Each record observable from the program's final state, computed in
    ``dtype`` over every chain: {name: (mean over chains, mean of the chains'
    magnitudes)}, in float64 on the host."""
    means = {k: getattr(state, k).to(dtype) for k in
             ("mag_mean", "mag2_mean", "mag4_mean", "absmag_mean", "phi2_mean")}
    out = {}
    for k, v in ref.observables(means, volume).items():
        x = v.double().cpu().numpy()
        out[k] = (float(np.mean(x)), float(np.mean(np.abs(x))))
    return out


def _record_gap(got: float, want: float, scale: float) -> float:
    """|got − want| over the larger of |want| and the chains' mean magnitude
    (the plain gap where both are 0)."""
    d = abs(float(got) - want)
    if not np.isfinite(d):
        return float("inf")
    s = max(abs(want), scale)
    return d / s if s > 0 else d


def _state_gap(got: ref.State, want: ref.State) -> float:
    return max(_gap(getattr(got, k).double().cpu().numpy(),
                    getattr(want, k).double().cpu().numpy()) for k in ref.FLOAT_LEAVES)


def _decisions(got: ref.State, want: ref.State, got_m=None, want_m=None) -> int:
    """Chains whose exact leaves differ, plus chain-frames whose stable flag
    or Δτ differ."""
    bad = torch.zeros(got.phi.shape[0], dtype=torch.bool)
    for k in ref.EXACT_LEAVES:
        g, w = getattr(got, k).cpu(), getattr(want, k).cpu()
        bad |= (g != w).reshape(g.shape[0], -1).any(dim=-1)
    n = int(bad.sum()) + (got.step != want.step) * got.phi.shape[0]
    if got_m is not None:
        n += sum(int((got_m[k].cpu() != want_m[k].cpu()).sum()) for k in _METRICS)
    return n
