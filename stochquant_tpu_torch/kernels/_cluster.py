"""The thread-block-cluster geometry of kernels 3, 4 (``field_kernel``) and 10,
11, 12 (``gauge_kernel``): pure Python, mirrored by ``csrc/cluster.cuh``.

A chain runs on a cluster of B blocks, B in :data:`SIZES`. Block rank b owns
the rows ``[b L0 // B, (b + 1) L0 // B)`` (:func:`strips`) and keeps them,
with one halo row a side, in shared memory for the whole frame; B = 1 is the
one block per chain whose state lives in global memory. A wrapper builds the
candidate geometries of its lattice (:func:`candidates`: every B ≤ L0 whose
strip fits one block's shared memory, the scratch in shared memory where it
fits too) and :func:`choose` takes the one of least cost, waves of chains
times the rows a block works through, ties going to the larger B. How many
chains the card runs at once in a geometry is the card's own answer
(``cudaOccupancyMaxActiveClusters``: clusters must sit inside one GPC, so it
is not 132 / B), asked once per geometry and cached
(:func:`resident_on_card`); the rule takes it as an argument, so it is
testable without a card. The fewest waves alone is not the rule: the card
holds 30 clusters of 4, 15 of 8 and 7 of 16 (GPCs of 14 to 18 SMs), so 32
chains of u1 256^2 would run one wave of whole lattices at B = 1 (21 ms) where
two waves of quarter strips take half that; the cost counts the rows one SM
works through and a micro-step's fixed cluster cost (:data:`STEP_OPS`,
measured).  Kernel 12 cuts the rows of its halo-extended block the same way,
with no ring (its first rank has nothing above, its last nothing below) and
two buffers of its strip a block (:func:`gauge_chunk_smem_floats`).

:func:`forced` pins B for the launches inside it (the card's tests and the
timing tool hold every B against the others); a geometry that does not fit
raises, and a launch the card refuses raises — nothing drops to B = 1 quietly.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

from stochquant_tpu_torch.kernels import _build

SIZES = (1, 2, 4, 8, 16)   # blocks a chain; 16 needs the non-portable cluster size
SMEM_LIMIT = 232_448       # dynamic shared memory one H100 block may use (227 KB)
MAX_CLUSTER = 16           # SQ_MAX_CLUSTER in csrc/cluster.cuh


class Geometry(NamedTuple):
    B: int                 # blocks a chain
    rows: int              # rows of the largest strip, ceil(L0 / B) (L0 at B = 1)
    smem: int              # shared-memory bytes a block (0 at B = 1)
    scratch_in_smem: bool  # the scratch (field: kept noise; gauge: F and kept noise)

    @property
    def placement(self) -> str:
        """Where the state lives, for the records."""
        if self.B == 1:
            return "global (one block a chain)"
        scratch = "shared" if self.scratch_in_smem else "global"
        return f"strip shared, scratch {scratch}"


def strips(L0: int, B: int) -> list:
    """[(first row, end row)] of ranks 0 .. B-1 (``make_strip`` in cluster.cuh)."""
    return [(b * L0 // B, (b + 1) * L0 // B) for b in range(B)]


def field_smem_floats(rows: int, L1: int, noise_planes: int, scratch: bool) -> int:
    """``field_cl_floats`` of csrc/field_kernel.cu: two strips with halo rows,
    the kept noise of own sites if in shared memory, the slice means, the warp
    partials, two slots and the gathered slots."""
    noise = noise_planes * rows * L1 if scratch else 0
    return 2 * (rows + 2) * L1 + noise + rows + 6 * 32 + 2 * 8 + 8 * MAX_CLUSTER


def gauge_smem_floats(rows: int, L1: int, P: int, FP: int, NP: int, scratch: bool) -> int:
    """``gauge_cl_floats`` of csrc/gauge_kernel.cu: the link planes' strips with
    halo rows, F and the kept noise (as wide) if in shared memory, the warp
    partials, the slot and the gathered slots."""
    strip = (rows + 2) * L1
    return P * strip + ((FP + NP) * strip if scratch else 0) + 3 * 32 + 4 + 3 * MAX_CLUSTER


def gauge_chunk_smem_floats(rows: int, L1: int, P: int, NP: int, W: int, scratch: bool) -> int:
    """``gauge_chunk_floats`` of csrc/gauge_kernel.cu (kernel 12 at B > 1): two
    buffers of the link planes' strips with halo rows, the kept noise of the
    strip's rows if in shared memory, then the partials of W micro-steps (a
    drift max a step and warp, the warps' sums, the slot, the gathered slots,
    the chain's drift max a step)."""
    kept = NP * rows * L1 if scratch else 0
    return 2 * P * (rows + 2) * L1 + kept + 32 * (W + 1) + (1 + MAX_CLUSTER) * (W + 2) + W


def candidates(L0: int, smem_floats: Callable[[int, bool], int]) -> list:
    """B = 1, then every B ≤ L0 whose strip fits one block: the scratch in
    shared memory where that fits too, else in global memory."""
    out = [Geometry(1, L0, 0, False)]
    for B in SIZES[1:]:
        if B > L0:
            break
        rows = -(-L0 // B)
        for scratch in (True, False):
            smem = 4 * smem_floats(rows, scratch)
            if smem <= SMEM_LIMIT:
                out.append(Geometry(B, rows, smem, scratch))
                break
    return out


#: What a cluster micro-step's barriers, halo publication and fixed-order
#: reduction cost one block, in counted site operations (``SITE_OPS`` of the
#: wrappers): fitted to the H100's times of kernels 3, 4 and 10 at every B
#: (PERF.md §6), where it is 16 rows of the 256-wide φ⁴ field.
STEP_OPS = 475_000


def overhead_rows(site_ops: float, L1: int) -> int:
    """:data:`STEP_OPS` in rows of a lattice ``L1`` wide whose site update
    counts ``site_ops`` operations."""
    return -(-STEP_OPS // int(site_ops * L1))


def choose(n_chains: int, cands: list, resident: Callable[[Geometry], int],
           step_rows: int = 0) -> Geometry:
    """The candidate of least cost, ties going to the larger B.  The cost is
    what one SM works through in turn: waves ceil(n_chains / resident(g)) of
    a strip of g.rows rows, plus at B > 1 a micro-step's fixed cluster cost of
    ``step_rows`` rows (:func:`overhead_rows`).  ``resident(g)`` is how many
    chains the card runs at once in geometry g (0: none)."""
    best = None
    for g in cands:
        n = resident(g)
        if n < 1:
            continue
        waves = -(-n_chains // n)
        key = (waves * (g.rows + (step_rows if g.B > 1 else 0)), -g.B)
        if best is None or key < best[0]:
            best = (key, g)
    if best is None:
        raise RuntimeError("no cluster geometry of these kernels fits the card")
    return best[1]


_FORCED: Optional[int] = None
_EMPTY = False


@contextlib.contextmanager
def forced(B: int, empty: bool = False):
    """Launch kernels 3, 4, 10, 11 and 12 at B blocks a chain inside this block.
    ``empty`` (B > 1 only; for timing) skips the site work of every
    micro-step and keeps its barriers and reductions: the results are not
    the frame's."""
    global _FORCED, _EMPTY
    if B not in SIZES:
        raise ValueError(f"cluster size {B} is not one of {SIZES}")
    if empty and B == 1:
        raise ValueError("the empty micro-step exists only at B > 1")
    before = _FORCED, _EMPTY
    _FORCED, _EMPTY = B, empty
    try:
        yield
    finally:
        _FORCED, _EMPTY = before


def forced_geometry(cands: list) -> Optional[Geometry]:
    """The candidate of the B that :func:`forced` pins, None where no B is
    pinned; raises where the pinned B does not fit this lattice."""
    if _FORCED is None:
        return None
    for g in cands:
        if g.B == _FORCED:
            return g
    raise ValueError(f"cluster size B={_FORCED} does not fit this lattice (B <= L0 and a strip "
                     f"within {SMEM_LIMIT} bytes of shared memory)")


def apply(params, g: Geometry) -> None:
    """Write geometry g into a FieldParams / GaugeParams launch struct."""
    params.cl_B, params.cl_rows, params.cl_scratch = g.B, g.rows, int(g.scratch_in_smem)
    params.cl_empty = int(_EMPTY)


_RESIDENT: dict = {}


def resident_on_card(entry: str, params, g: Geometry, multi: bool, device, key) -> int:
    """Chains the card runs at once in geometry g: the library's ``entry``
    (``sq_field_resident`` / ``sq_gauge_resident``) asked once per (device,
    ``key`` — what else decides the kernel's resources —, g, multi)."""
    k = (entry, str(device), key, g, bool(multi))
    if k not in _RESIDENT:
        p = type(params).from_buffer_copy(params)
        apply(p, g)
        _RESIDENT[k] = _build.resident(entry, p, multi, device)
    return _RESIDENT[k]
