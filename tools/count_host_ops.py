#!/usr/bin/env python3
"""Count the PyTorch (aten) ops the ``cuda_step`` field halo runner issues on
the host per micro-step and shard.

    python3 tools/count_host_ops.py [--root DIR]

Runs on the CPU: kernel 9 is replaced by a stand-in that does on the host
what its CUDA wrapper does (the halo slices made contiguous, the output
allocations, the two reductions of the per-strip partials) and no
arithmetic, so the count is the runner's and the wrapper's own.  A frame of
10 micro-steps and one of 2 on a 32^2 x 4 lattice split in two (x = 2) are
counted under a dispatch mode; their difference over 8 micro-steps and 2
shards is the count per micro-step and shard.  ``--root`` takes the package
from another checkout (e.g. the parent commit unpacked with ``git
archive``), whose kernel 9 may take no halo slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from stochquant_tpu_torch import actions, parallel
    from stochquant_tpu_torch.config import FieldConfig
    from stochquant_tpu_torch.integrators import field
    from stochquant_tpu_torch.parallel.halo import make_halo_runner

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    def stand_in(phi, dtau, action, cfg, pair_base, parity, half, offs, sharded, halos=None):
        C, L0, L1 = phi.shape
        for pair in (halos or {}).values():
            for h in pair:
                h.contiguous()
        out, sl, part = torch.empty(C, L0, L1), torch.empty(C, L0), torch.zeros(C, 4, 6)
        sums, maxima = part[:, :, :4].sum(dim=1), part[:, :, 4:].amax(dim=1)
        return out, sums[:, 0], sums[:, 1], sums[:, 2], sl, maxima[:, 0], sums[:, 3], maxima[:, 1]

    act = actions.get_field("phi4")
    mesh = parallel.make_mesh([("x", 2)], devices="cpu")
    counts = {}
    for loops in (10, 2):
        cfg = FieldConfig(action="phi4", shape=(32, 32), n_chains=4, loops=loops, dtau=0.01,
                          seed=3, mesh_axes=("x", None))
        s0 = field.init_field_state(dataclasses.replace(cfg, mesh_axes=None), device="cpu")
        runner = make_halo_runner(act, cfg, mesh, backend="cuda_step", step=stand_in)
        shards = parallel.shard_field_state(s0, mesh, cfg)
        runner(shards, 1)  # warm-up
        with Count() as c:
            runner(shards, 1)
        counts[loops] = c.n
    per_step = (counts[10] - counts[2]) / (8 * 2)
    print(f"{args.root}: {counts[10]} aten ops a frame of 10 micro-steps at x = 2, "
          f"{per_step:.1f} a micro-step and shard")
    return 0


if __name__ == "__main__":
    sys.exit(main())
