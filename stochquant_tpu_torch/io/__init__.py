"""I/O: full-state and sharded checkpoints (npz) and reference "%a" format
interop."""

from stochquant_tpu_torch.io import reference_fmt  # noqa: F401
from stochquant_tpu_torch.io.checkpoint import (  # noqa: F401
    export_reference,
    import_reference,
    load,
    save,
)
