"""Observables computed from a run's state: exact Gaussian answers, the gauge
loops, and autocorrelation-aware statistical analysis."""

from stochquant_tpu_torch.observables.gauge_loops import (  # noqa: F401
    creutz_ratio,
    polyakov_loop,
    wilson_flow,
    wilson_loop,
    wilson_loop_table,
)
from stochquant_tpu_torch.observables.exact import (  # noqa: F401
    em_stationary_cov,
    free_field_x2,
    harmonic_drift_matrix,
    harmonic_x2_continuum,
    target_cov,
)
