"""A state split over a device mesh: the mesh and its collectives
(:mod:`.mesh`), the field halo runner (:mod:`.halo`), the gauge halo and
chunk runners (:mod:`.gauge_halo`) and meshes across processes
(:mod:`.distributed`)."""

from stochquant_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceMesh,
    gather_chain_state,
    gather_field_state,
    gather_gauge_state,
    make_mesh,
    shard_chain_state,
    shard_field_state,
    shard_gauge_state,
    shard_state_from_numpy,
)
