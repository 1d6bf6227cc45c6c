"""CUDA tensors between processes: device memory the processes map into each
other, ordered on their streams by counters (the port's own; the JAX package
gets this transport from XLA and the TPU interconnect).

A lattice split across processes (``parallel.distributed.global_mesh``)
runs one program a process.  Its collectives (``parallel.mesh``) move CPU
tensors through gloo; a CUDA tensor goes through a :class:`Transport`, which
a runner attaches to its mesh (:func:`attach`) and closes at its end:

* **the board**: two slots of device memory a process, which every other
  process maps (CUDA IPC, ``csrc/ipc.cu``).  A collective copies this
  process's shards' tensors into slot ``n mod 2`` (its ``n``-th call), sets
  its PUB counter to ``n``; a reader's stream waits until the writer's PUB is
  ≥ ``n``, copies what it needs into tensors of its own, and sets its ACK
  counter to ``n``.  Before writing slot ``n mod 2`` a process waits until
  every peer's ACK is ≥ ``n − 2``: nobody still reads what it overwrites;
* **kernel 8's ring** (:class:`Ring`): two exported slabs a shard.
  Chunk ``k`` waits until each dim-0 neighbour's EPOCH is ≥ ``k``, reads the
  neighbours' slab ``k mod 2``, writes its own slab ``(k + 1) mod 2`` and
  sets EPOCH to ``k + 1`` (the JAX kernel's barrier semaphore,
  ``field_kernel_nd.py:625-628``, and its cross-launch safety, ``:619-623``).

The counters are 32-bit words in this process's device memory, written by
``cuStreamWriteValue32`` after the work before it on the stream and waited
on by the peers' streams (``cuStreamWaitValue32``, ≥ modulo 2^32): never a
spin inside a kernel, and no host round trip.  They are the transport's own
sequence numbers, zeroed behind a barrier when a runner attaches it, so every
process of a run (a resumed one too: new processes, new runners) counts from
the same start.

Layout: every shard of a process on one CUDA device (one process per card;
several processes may share one card).  The exported buffers are allocated
by ``cudaMalloc`` in ``csrc/ipc.cu``, not by PyTorch's caching allocator (an
IPC handle names a whole allocation, and expandable segments cannot be
exported at all), and are held until :meth:`Transport.close`, which frees
them only after a barrier, once no peer reads them.  A wait that does not
end within ``timeout_s`` raises at the next :meth:`Transport.settle`,
naming the process and the shards it waited for.  Nothing falls back: a
missing capability raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch

from stochquant_tpu_torch.kernels import _build
from stochquant_tpu_torch.parallel import distributed

__all__ = ["Transport", "Ring", "Remote", "attach"]

#: the counters of a process, 32-bit words of its flags buffer
PUB, ACK, EPOCH, PROBE = 0, 1, 2, 3
_WORDS = ("PUB", "ACK", "EPOCH")
_ALIGN = 256
#: the first board slot's bytes; a call that needs more grows the board
BOARD_BYTES = 1 << 20
#: how long a process waits for another before :meth:`Transport.settle` raises
TIMEOUT_S = 300.0
_DRIVER = 100000


def _check(rc: int, what: str) -> None:
    if rc == 0:
        return
    if rc >= _DRIVER:
        raise RuntimeError(f"{what} failed: CUDA driver error CUresult {rc - _DRIVER}")
    raise RuntimeError(f"{what} failed: {_build.library().sq_error_string(rc).decode()} ({rc})")


class _Buffer:
    """``nbytes`` of device memory of this process, exported (its handle) and
    viewable as tensors."""

    def __init__(self, nbytes: int, device: torch.device):
        lib = _build.library()
        self.device, self.nbytes = device, nbytes
        ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
        with torch.cuda.device(device):
            _check(lib.sq_ipc_alloc(nbytes, ctypes.byref(ptr), handle), "cudaMalloc + IPC export")
        self.ptr, self.handle = ptr.value, handle.raw

    def tensor(self, offset: int, shape) -> torch.Tensor:
        """A float32 tensor over ``[offset, …)`` of this buffer (no copy)."""
        n = torch.Size(shape).numel() * 4
        if offset % _ALIGN or offset + n > self.nbytes:
            raise ValueError(f"a view of {n} bytes at {offset} lies outside the buffer")
        view = torch.as_tensor(_Interface(self.ptr + offset, tuple(shape), self))
        if view.data_ptr() != self.ptr + offset or view.device != self.device:
            raise RuntimeError("torch.as_tensor copied an exported buffer instead of viewing it")
        return view

    def free(self) -> None:
        if self.ptr:
            with torch.cuda.device(self.device):
                _check(_build.library().sq_ipc_free(ctypes.c_void_p(self.ptr)), "cudaFree")
            self.ptr = 0


class _Interface:
    """``__cuda_array_interface__`` of a float32 span of a :class:`_Buffer`;
    keeps it alive."""

    def __init__(self, ptr: int, shape: tuple, owner):
        self.owner = owner
        self.__cuda_array_interface__ = {"shape": shape, "typestr": "<f4",
                                         "data": (ptr, False), "version": 2, "strides": None}


@dataclasses.dataclass(frozen=True)
class Remote:
    """A slab of another process's device memory, mapped into this one: what
    kernel 8 reads its halo rows from (``field_kernel_nd.field_chunk_rdma_nd``
    takes it for ``left`` / ``right``).  ``device`` is this process's card
    (the mapping reads the owner's card through peer access where it is
    another)."""

    ptr: int
    shape: torch.Size
    dtype: torch.dtype
    device: torch.device

    def data_ptr(self) -> int:
        return self.ptr

    def is_contiguous(self) -> bool:
        return True


class _Call:
    """One collective's use of the board: fetch what this process reads, then
    :meth:`done`."""

    def __init__(self, transport: "Transport", n: int, like: list, per: int):
        self.t, self.n, self.like, self.per = transport, n, like, per
        self.waited = set()

    def fetch(self, proc: int, i: int) -> torch.Tensor:
        """Process ``proc``'s shard ``i``'s tensor of this call, copied into a
        fresh tensor of this process."""
        t = self.t
        if proc not in self.waited:
            t._wait(proc, PUB, self.n)
            self.waited.add(proc)
        like = self.like[0]
        out = torch.empty(like.shape, dtype=like.dtype, device=t.device)
        src = t._peer_board[proc] + (self.n % 2) * t.cap + i * self.per
        _check(t.lib.sq_ipc_copy(ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(src),
                                 out.nbytes, t.stream()), "copy from a peer's board")
        return out

    def done(self) -> None:
        self.t._signal(ACK, self.n)


class Transport:
    """This process's end of the cross-process transport of ``mesh`` (see the
    module's docstring).  Every process of the mesh builds it at the same
    point (it exchanges handles over gloo)."""

    def __init__(self, mesh, timeout_s: float = TIMEOUT_S):
        devices = set(mesh.devices)
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(
                "a mesh across processes on CUDA devices puts every shard of a process on one "
                "card (one process per card; processes may share a card), not "
                f"{sorted(map(str, devices))}")
        self.mesh, self.device = mesh, next(iter(devices))
        self.rank, self.nproc = mesh.process_index, mesh.process_count
        self.peers = [p for p in range(self.nproc) if p != self.rank]
        self.timeout_s = timeout_s
        self.lib = _build.library()
        self.flags = _Buffer(_ALIGN, self.device)
        attribute = ctypes.c_int(-1)
        with torch.cuda.device(self.device):
            probe = ctypes.c_void_p(self.flags.ptr + 4 * PROBE)
            rc = self.lib.sq_ipc_check(self.device.index, probe, self.stream(),
                                       ctypes.byref(attribute))
        if rc:
            raise RuntimeError(
                "the card or driver lacks stream memory operations (cuStreamWriteValue32 / "
                "cuStreamWaitValue32; CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1 = "
                f"{attribute.value}), which order the cross-process transport: error {rc}")
        self._opened = []
        self._peer_flags = self._open_all(self.flags.handle)
        self.board, self.cap, self.seq = None, 0, 0
        self._awaited = {}
        self._slabs = []
        distributed.barrier()  # every process's counters are zero before anyone waits

    # -- primitives ---------------------------------------------------------

    def stream(self) -> ctypes.c_void_p:
        return ctypes.c_void_p(torch.cuda.current_stream(self.device).cuda_stream)

    def _open_all(self, handle: bytes) -> dict:
        """Every peer's buffer of this exchange, mapped: {process: pointer}."""
        handles = distributed.all_gather_objects(handle)
        out = {}
        with torch.cuda.device(self.device):
            for p in self.peers:
                ptr = ctypes.c_void_p()
                handle = ctypes.create_string_buffer(handles[p], 64)
                _check(self.lib.sq_ipc_open(handle, ctypes.byref(ptr)),
                       f"cudaIpcOpenMemHandle (process {p})")
                self._opened.append(ptr.value)
                out[p] = ptr.value
        return out

    def _signal(self, word: int, value: int) -> None:
        _check(self.lib.sq_ipc_signal(self.stream(), ctypes.c_void_p(self.flags.ptr + 4 * word),
                                      value & 0xFFFFFFFF), "cuStreamWriteValue32")

    def _wait(self, proc: int, word: int, value: int) -> None:
        self._awaited[(proc, word)] = value
        _check(self.lib.sq_ipc_wait(self.stream(),
                                    ctypes.c_void_p(self._peer_flags[proc] + 4 * word),
                                    value & 0xFFFFFFFF), "cuStreamWaitValue32")

    # -- the board ----------------------------------------------------------

    def publish(self, xs: list) -> _Call:
        """Copy this process's shards' tensors (one shape and dtype) into the
        board for the next collective; returns the call that reads the peers'."""
        per = -(-xs[0].nbytes // _ALIGN) * _ALIGN
        if per * len(xs) > self.cap:
            self._grow(per * len(xs))
        self.seq += 1
        n = self.seq
        if n > 2:
            for p in self.peers:
                self._wait(p, ACK, n - 2)
        base = self.board.ptr + (n % 2) * self.cap
        for i, x in enumerate(xs):
            x = x.contiguous()
            _check(self.lib.sq_ipc_copy(ctypes.c_void_p(base + i * per),
                                        ctypes.c_void_p(x.data_ptr()), x.nbytes, self.stream()),
                   "copy into the board")
        self._signal(PUB, n)
        return _Call(self, n, xs, per)

    def _grow(self, need: int) -> None:
        """A larger board in every process (each reaches the same call with the
        same shapes): the old one is dropped once nobody reads it."""
        torch.cuda.synchronize(self.device)
        distributed.barrier()
        if self.board is not None:
            self._close_peers(self._peer_board.values())
            self.board.free()
        self.cap = max(need, 2 * self.cap, BOARD_BYTES)
        self.board = _Buffer(2 * self.cap, self.device)
        self._peer_board = self._open_all(self.board.handle)

    # -- end ----------------------------------------------------------------

    def settle(self) -> None:
        """Block until this process's stream has done its work; past
        ``timeout_s`` raise, naming the processes (and their shards) whose
        counters the stream has waited on since the last settle: one of them
        is behind.  (Reading a peer's counter from the host would queue
        behind the blocked stream itself.)"""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        deadline = time.monotonic() + self.timeout_s
        while not event.query():
            if time.monotonic() > deadline:
                waits = [f"process {p} (global shards "
                         f"{[p * self.mesh.size + i for i in range(self.mesh.size)]}): "
                         f"{_WORDS[word]} >= {want}"
                         for (p, word), want in sorted(self._awaited.items())]
                raise TimeoutError(f"process {self.rank} waited over {self.timeout_s:g} s for "
                                   f"another process; its stream waits on " + "; ".join(waits))
            time.sleep(1e-4)
        self._awaited.clear()

    def _close_peers(self, ptrs) -> None:
        ptrs = list(ptrs)
        with torch.cuda.device(self.device):
            for ptr in ptrs:
                _check(self.lib.sq_ipc_close(ctypes.c_void_p(ptr)), "cudaIpcCloseMemHandle")
        self._opened = [q for q in self._opened if q not in ptrs]

    def close(self) -> None:
        """Unmap the peers' buffers and free this process's, behind barriers:
        every stream done, every mapping closed, then the memory freed."""
        if self.flags is None:
            return
        torch.cuda.synchronize(self.device)
        distributed.barrier()
        self._close_peers(list(self._opened))
        distributed.barrier()
        for buf in [self.flags, self.board] + self._slabs:
            if buf is not None:
                buf.free()
        self.flags = self.board = None
        self._slabs = []


class Ring:
    """Kernel 8's slabs over the transport ``t``: two exported float32 slabs
    of ``shape`` for each of this process's shards, mapped into every other
    process once (every process builds it at the same point).  ``own[k %
    2][i]`` is this process's shard ``i``'s slab for chunk ``k`` (a tensor),
    :meth:`slab` any global shard's (a tensor of this process, or a
    :class:`Remote` of another's)."""

    def __init__(self, t: Transport, shape):
        self.t, self.shape = t, tuple(shape)
        n = torch.Size(shape).numel() * 4
        self.per = -(-n // _ALIGN) * _ALIGN
        size = t.mesh.size
        buf = _Buffer(2 * size * self.per, t.device)
        t._slabs.append(buf)
        self.own = [[buf.tensor((q * size + i) * self.per, self.shape) for i in range(size)]
                    for q in range(2)]
        self.peer = t._open_all(buf.handle)
        self.k = 0

    def wait(self, procs, k: int) -> None:
        """The work put on the stream after this waits until every process
        of ``procs`` has set its epoch to ``k`` or more."""
        for p in procs:
            self.t._wait(p, EPOCH, k)

    def set(self, k: int) -> None:
        """After the work already on the stream: this process's epoch = ``k``."""
        self.t._signal(EPOCH, k)

    def slab(self, g: int, q: int):
        """Global shard ``g``'s slab ``q``."""
        mesh = self.t.mesh
        i = mesh.local(g)
        if i is not None:
            return self.own[q][i]
        ptr = self.peer[mesh.owner(g)] + (q * mesh.size + g % mesh.size) * self.per
        return Remote(ptr, torch.Size(self.shape), torch.float32, self.t.device)


def attach(mesh):
    """``mesh`` with a :class:`Transport` where it spans processes on CUDA
    devices (every process calls this at the same point), else ``mesh``."""
    if mesh.process_count == 1 or mesh.devices[0].type != "cuda":
        return mesh
    return dataclasses.replace(mesh, transport=Transport(mesh))
