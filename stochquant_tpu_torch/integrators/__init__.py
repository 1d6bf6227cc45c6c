"""Langevin integrators on the plain PyTorch path: 1-D chains (with
collective coordinate), D-dim fields, lattice gauge links and complex
Langevin."""

from stochquant_tpu_torch.integrators.field import (  # noqa: F401
    FieldState,
    init_field_state,
    make_field_frame_fn,
    reset_field_means,
    run_field_frames,
    susceptibility,
)
from stochquant_tpu_torch.integrators.complex_field import (  # noqa: F401
    ComplexFieldConfig,
    ComplexFieldState,
    init_cfield_state,
    reset_cfield_means,
    run_cfield_frames,
)
from stochquant_tpu_torch.integrators.gauge import (  # noqa: F401
    GaugeConfig,
    GaugeState,
    init_gauge_state,
    reset_gauge_means,
    run_gauge_frames,
)
from stochquant_tpu_torch.integrators.langevin import (  # noqa: F401
    ChainState,
    connected_correlator,
    init_chain_state,
    make_frame_fn,
    reset_means,
    run_frames,
)
