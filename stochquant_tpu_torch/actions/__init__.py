"""Action registry for 1-D quantum mechanics (``actions.get(name)``)."""

from stochquant_tpu_torch.actions.base import QMAction, get, names, register  # noqa: F401
from stochquant_tpu_torch.actions.quantum_mechanics import (  # noqa: F401
    AnharmonicOscillator,
    DoubleWell,
    HarmonicOscillator,
    PoeschlTeller,
)
