"""Config 4's scaling story end to end on a mesh whose eight positions repeat
one device (no pod and no environment variable needed).

Runs the 4-D φ⁴ lattice through the halo runner's chunk kernel
(``parallel.halo.make_halo_runner(..., backend="cuda")``: kernel 7) under
every geometry a real pod uses:

  1. dim-0 slab ring (the 32⁴/N-chip layout, thin slabs via multi-hop),
  2. dims-0+1 2-D decomposition (corners via two-phase exchange),
  3. chain-DP × lattice hybrid,

and checks each against the unsplit pair kernel (kernel 6,
``field_kernel_nd.run_field_frames_nd``) BITWISE — the global-counter noise
makes every placement produce the identical trajectory, so scaling out is a
pure layout decision.  On the CPU both run their plain versions.

Run:  python -m stochquant_tpu_torch.examples.sharded_4d_scaling [--device cpu]
"""

import dataclasses

import numpy as np

from stochquant_tpu_torch.actions import phi4
from stochquant_tpu_torch.config import FieldConfig
from stochquant_tpu_torch.examples import cli_device
from stochquant_tpu_torch.integrators import field
from stochquant_tpu_torch.kernels import field_kernel_nd
from stochquant_tpu_torch.parallel import make_mesh, shard_field_state
from stochquant_tpu_torch.parallel.halo import make_halo_runner
from stochquant_tpu_torch.parallel.mesh import gather_field_state
from stochquant_tpu_torch.runtime import resolve_device

GEOMETRIES = [
    ("dim-0 slab ring (8-way)", ("x", None, None, None), [("x", 8)], None),
    ("dims 0+1 (2x4)", ("x", "y", None, None), [("x", 2), ("y", 4)], None),
    ("chains x dims 0+1", ("x", "y", None, None),
     [("chain", 2), ("x", 2), ("y", 2)], "chain"),
]


def main(device="cuda", *, shape=(16, 8, 4, 32), n_chains=2, loops=8, frames=2):
    device = resolve_device(device)
    base = FieldConfig(
        action="phi4", shape=tuple(shape), dtau=0.005, n_chains=n_chains, loops=loops,
        seed=42, grow_after=10**9,
    )
    act = phi4.get_field(base.action)
    s0 = field.init_field_state(base, device=device)
    ref, _ = field_kernel_nd.run_field_frames_nd(s0, act, base, frames)
    print(f"unsharded reference: <phi^2> = "
          f"{ref.phi2_mean.cpu().numpy().astype(np.float64).mean():.6f}")

    results = {}
    for name, axes, mesh_shape, chain_ax in GEOMETRIES:
        cfg = dataclasses.replace(base, mesh_axes=axes, mesh_chain_axis=chain_ax)
        mesh = make_mesh(mesh_shape, devices=device)
        runner = make_halo_runner(act, cfg, mesh, backend="cuda")
        out, metrics = runner(shard_field_state(s0, mesh, cfg), frames)
        runner.close()
        bitwise = bool(np.array_equal(ref.phi.cpu().numpy(),
                                      gather_field_state(out, mesh, cfg).phi.cpu().numpy()))
        stable = float(metrics["stable"].float().mean())
        results[name] = {"bitwise": bitwise, "stable": stable, "devices": mesh.size}
        print(f"{name:28s} devices={mesh.size}  "
              f"bitwise={'YES' if bitwise else 'NO'}  "
              f"stable={stable:.2f}")
        assert bitwise
    print("every placement reproduced the identical trajectory.")
    return {"phi2": float(ref.phi2_mean.cpu().numpy().astype(np.float64).mean()),
            "placements": results}


if __name__ == "__main__":
    main(cli_device(__doc__))
