"""The JAX package's example workflows on the port, one module each, run as
``python -m stochquant_tpu_torch.examples.<name> [--device cpu]``:

* ``energy_gap`` — harmonic chain → connected correlator → gap fit against
  the lattice E(Δt) (kernel 1 on the card);
* ``binder_crossing`` — the Binder cumulant of 2-D φ⁴ at two sizes across m²
  (kernel 3);
* ``phi4_phase_scan`` — ⟨|M|⟩, χ and ⟨φ²⟩ of 2-D φ⁴ across m² (kernel 3);
* ``scheme_bias_ladder`` — the exact stationary bias of EM / Heun / LM and a
  Scheme.EXACT run far beyond their stability bound (the plain paths, which
  no kernel implements in either package);
* ``sharded_4d_scaling`` — 4-D φ⁴ split three ways over a mesh whose eight
  positions repeat one device, each bitwise the unsplit run (kernel 7 against
  kernel 6).

Each ``main(device="cuda", ...)`` takes the JAX script's sizes by default and
returns what it printed as numbers.  The device is the caller's: on a CUDA
device the kernel wrappers launch their kernels, on ``"cpu"`` (asked for)
they run their plain versions; nothing falls back on its own."""

import argparse

__all__ = ["cli_device"]


def cli_device(description: str) -> str:
    """The ``--device`` of an example's command line (default ``cuda``)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels; the default) or cpu (their plain versions)")
    return parser.parse_args().device
