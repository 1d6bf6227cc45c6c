"""Action registries: 1-D quantum mechanics (``actions.get(name)``) and
D-dimensional scalar fields (``actions.get_field(name)``)."""

from stochquant_tpu_torch.actions.base import QMAction, get, names, register  # noqa: F401
from stochquant_tpu_torch.actions.quantum_mechanics import (  # noqa: F401
    AnharmonicOscillator,
    DoubleWell,
    HarmonicOscillator,
    PoeschlTeller,
)
from stochquant_tpu_torch.actions.phi4 import (  # noqa: F401
    FieldAction,
    FreeField,
    ScalarPhi4,
    field_names,
    get_field,
    periodic_laplacian,
)
