"""Action registries: 1-D quantum mechanics (``actions.get(name)``, the
reference's potID dispatch as a registry), D-dimensional scalar fields
(``actions.get_field(name)``), complex actions (``actions.get_complex``) and
gauge groups (``actions.get_gauge``, the complexified ones included)."""

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
from stochquant_tpu_torch.actions.complex_actions import (  # noqa: F401
    ComplexAction,
    ComplexGaussian,
    ComplexQuartic,
    complex_names,
    get_complex,
)
from stochquant_tpu_torch.actions.gauge import (  # noqa: F401
    GaugeAction,
    SU2Wilson,
    U1Wilson,
    gauge_names,
    get_gauge,
)
from stochquant_tpu_torch.actions.gauge_complex import (  # noqa: F401
    ComplexSUNWilson,
    ComplexU1Wilson,
)

# potID <-> name mapping of the reference CLI
POT_ID_TO_NAME = {0: "harmonic", 1: "poeschl_teller", 2: "anharmonic", 3: "double_well"}
NAME_TO_POT_ID = {v: k for k, v in POT_ID_TO_NAME.items()}
