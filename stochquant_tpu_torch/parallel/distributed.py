"""Several processes (port of ``stochquant_tpu.parallel.distributed``).

The JAX package spans hosts with ``jax.distributed``: every process adds its
devices to one global mesh and runs its part of a global state, and XLA
carries the halos between them.  Here the processes form a
``torch.distributed`` group on the gloo backend and each holds the shards of
its own positions of a global mesh (:func:`global_mesh`).  Every process
runs the same program on its shards: ``runtime.run_chain`` over its part of
the chains (``chain_kernel.run_frames_kernel(..., chain_offset=)``, no
cross-process ``run_chain``, as in the JAX package), and
``runtime.run_field`` / ``run_gauge`` on a lattice split across processes,
whose collectives (``parallel.mesh``) cross processes: CPU tensors through
gloo (:func:`all_gather`), CUDA tensors through device memory that the
processes map into each other (``parallel.ipc``: CUDA IPC, ordered on the
streams by counters), never through gloo or the host.  gloo carries only
CPU tensors, the IPC handles (:func:`all_gather_objects`), barriers, the
per-record scalars of a chain run (:func:`all_sum`); a sharded checkpoint
is one file a process (``io.checkpoint.save_sharded`` / ``load_sharded``).
gloo, because NCCL refuses two ranks on one GPU and the tests run on the
CPU.

Usage (one process per rank; on a node with several cards one process a
card, on one card several processes share it):

    from stochquant_tpu_torch.parallel import distributed
    distributed.initialize()                   # torch's env://, or a file store
    mesh = distributed.global_mesh([("x", 4)], devices=f"cuda:{local_rank}")
    runtime.run_field(cfg, mesh=mesh)          # cfg.mesh_axes = ("x", None)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from stochquant_tpu_torch.parallel.mesh import DeviceMesh, make_mesh

__all__ = ["initialize", "global_mesh", "process_local_chains", "all_sum", "rank_and_size",
           "barrier", "all_gather", "all_gather_objects"]


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, timeout_s: float = 60.0) -> None:
    """Join the process group (gloo): with ``init_method`` (``tcp://host:port``
    or ``file://path``), ``world_size`` and ``rank``, or from torch's
    ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  A no-op in a single process with nothing configured."""
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group(
        backend="gloo", init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def rank_and_size() -> Tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axes: Sequence[Tuple[str, int]], devices=None) -> DeviceMesh:
    """A mesh over every process's positions: ``axes`` are the global (name,
    size) pairs, this process holds the contiguous run ``rank · n / P …`` of
    the n positions in C order (the first axis spans the processes and must
    divide among them), on ``devices`` as ``parallel.make_mesh`` takes them
    (default: one CUDA device per local position; a device may repeat)."""
    names = [n for n, _ in axes]
    sizes = [int(s) for _, s in axes]
    rank, nproc = rank_and_size()
    if sizes[0] % nproc:
        raise ValueError(f"mesh {dict(axes)}: its first axis ({sizes[0]}) must divide among "
                         f"{nproc} processes")
    local = make_mesh([(names[0], sizes[0] // nproc)] + list(axes[1:]), devices)
    return DeviceMesh(tuple(names), tuple(sizes), local.devices, rank, nproc)


def process_local_chains(total_chains: int) -> Tuple[int, int]:
    """(chains on this process, the global id of its first)."""
    pid, nproc = rank_and_size()
    per = total_chains // nproc
    if per * nproc != total_chains:
        raise ValueError(f"{total_chains} chains not divisible by {nproc} processes")
    return per, pid * per


def all_sum(values: Sequence[float]) -> list:
    """Each of ``values`` summed over the processes (float64 on the host, one
    gloo all-reduce); the values themselves outside a group."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    if rank_and_size()[1] > 1:
        dist.all_reduce(t)
    return t.tolist()


def barrier() -> None:
    """Every process of the group reaches this point; a no-op outside a group."""
    if rank_and_size()[1] > 1:
        dist.barrier()


def all_gather(x: torch.Tensor) -> list:
    """Every process's ``x`` (a CPU tensor of the same shape and dtype in each),
    in rank order: one gloo all-gather.  Bool and complex tensors travel as
    bytes and as real pairs.  A CUDA tensor raises: it never goes through gloo
    (``parallel.ipc`` moves those)."""
    if x.device.type != "cpu":
        raise ValueError(f"all_gather moves CPU tensors through gloo, not a tensor on {x.device}: "
                         "CUDA tensors cross processes through parallel.ipc")
    nproc = rank_and_size()[1]
    if nproc == 1:
        return [x]
    t = x.contiguous()
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    elif t.is_complex():
        t = torch.view_as_real(t)
    out = [torch.empty_like(t) for _ in range(nproc)]
    dist.all_gather(out, t)
    if x.dtype == torch.bool:
        return [o.view(torch.bool) for o in out]
    if x.is_complex():
        return [torch.view_as_complex(o) for o in out]
    return out


def all_gather_objects(obj) -> list:
    """Every process's picklable ``obj`` in rank order (gloo)."""
    nproc = rank_and_size()[1]
    if nproc == 1:
        return [obj]
    out = [None] * nproc
    dist.all_gather_object(out, obj)
    return out
