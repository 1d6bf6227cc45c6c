// Device memory shared between processes, and the counters that order it:
// the transport of a lattice split across processes (parallel/ipc.py).
//
// No TPU kernel is replaced here.  The JAX package moves a shard's halo
// between hosts through XLA and the TPU interconnect, and kernel 8
// (stochquant_tpu/kernels/field_kernel_nd.py:977, _sharded_chunk_call(rdma=True))
// orders its remote copies with a barrier semaphore (:625-628).  This file is
// the port's counterpart of both, and launches no kernel of its own:
//
// * CUDA IPC: a buffer is allocated here with cudaMalloc (never by PyTorch's
//   caching allocator, whose sub-blocks and expandable segments an IPC handle
//   cannot name), exported with cudaIpcGetMemHandle and mapped into the other
//   processes with cudaIpcOpenMemHandle (cudaIpcMemLazyEnablePeerAccess, so a
//   peer card is reached where the node gives peer access).  The handle is 64
//   opaque bytes that the Python side exchanges over gloo.
// * Stream memory operations: a process writes a monotone 32-bit counter in
//   its own device memory after its work on the stream (cuStreamWriteValue32,
//   which fences the writes before it), and a neighbour's stream waits until
//   the counter is at least a value (cuStreamWaitValue32, GEQ, which compares
//   modulo 2^32).  The wait is on the stream, never inside a kernel: contexts
//   of different processes time-slice one card, and a kernel spinning on a
//   flag would stall until the other context's slice came round.
// * Copies between this process's memory and a mapped peer buffer
//   (cudaMemcpyAsync with cudaMemcpyDefault on the caller's stream).
//
// What bounds it: the copies move bytes (a halo slab or a few partials); the
// counters cost a front-end operation each.  On one card several processes
// time-slice their contexts, so a wait can last until the peer's slice.
//
// The driver's stream memory operations come through cudaGetDriverEntryPoint
// (no link against libcuda).  Every entry returns 0 or an error code:
// a cudaError_t, or SQ_IPC_DRIVER + a CUresult.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int SQ_IPC_DRIVER = 100000;

typedef CUresult (*stream_value32_fn)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
typedef CUresult (*device_attribute_fn)(int*, CUdevice_attribute, CUdevice);

stream_value32_fn g_write32 = nullptr;
stream_value32_fn g_wait32 = nullptr;
device_attribute_fn g_attribute = nullptr;

int entry_point(const char* name, void** fn) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(name, fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || *fn == nullptr) return (int)cudaErrorSymbolNotFound;
    return 0;
}

int load_driver() {
    if (g_write32 && g_wait32 && g_attribute) return 0;
    int rc = entry_point("cuStreamWriteValue32", (void**)&g_write32);
    if (rc == 0) rc = entry_point("cuStreamWaitValue32", (void**)&g_wait32);
    if (rc == 0) rc = entry_point("cuDeviceGetAttribute", (void**)&g_attribute);
    return rc;
}

int driver(CUresult r) { return r == CUDA_SUCCESS ? 0 : SQ_IPC_DRIVER + (int)r; }

}  // namespace

// The value of CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1 (92) for
// `device`, then one write and one wait on `stream` over `word` (device
// memory of 4 bytes): an error here means the card or driver lacks stream
// memory operations, which the transport does not work without.
extern "C" int sq_ipc_check(int device, void* word, void* stream, int* attribute) {
    int rc = load_driver();
    if (rc) return rc;
    rc = driver(g_attribute(attribute, (CUdevice_attribute)92, (CUdevice)device));
    if (rc) return rc;
    rc = driver(g_write32((CUstream)stream, (CUdeviceptr)word, 1u, 0u));
    if (rc) return rc;
    rc = driver(g_wait32((CUstream)stream, (CUdeviceptr)word, 1u, CU_STREAM_WAIT_VALUE_GEQ));
    if (rc) return rc;
    return (int)cudaStreamSynchronize((cudaStream_t)stream);
}

// `bytes` of device memory on the current device, zeroed before this
// returns (a peer may wait on a counter in it as soon as it has the handle),
// and its IPC handle (64 bytes into `handle`).
extern "C" int sq_ipc_alloc(size_t bytes, void** ptr, void* handle) {
    cudaError_t e = cudaMalloc(ptr, bytes);
    if (e != cudaSuccess) return (int)e;
    e = cudaMemset(*ptr, 0, bytes);
    if (e == cudaSuccess) e = cudaDeviceSynchronize();
    if (e == cudaSuccess) {
        cudaIpcMemHandle_t h;
        e = cudaIpcGetMemHandle(&h, *ptr);
        if (e == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
    }
    if (e != cudaSuccess) {
        cudaFree(*ptr);
        *ptr = nullptr;
    }
    return (int)e;
}

extern "C" int sq_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// Map another process's buffer from its handle into this process.
extern "C" int sq_ipc_open(const void* handle, void** ptr) {
    cudaIpcMemHandle_t h;
    std::memcpy(&h, handle, sizeof(h));
    return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int sq_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// After the work already on `stream`: *word = value (preceded by a fence).
extern "C" int sq_ipc_signal(void* stream, void* word, unsigned int value) {
    if (int rc = load_driver()) return rc;
    return driver(g_write32((CUstream)stream, (CUdeviceptr)word, value, 0u));
}

// The work put on `stream` after this waits until *word >= value (mod 2^32).
extern "C" int sq_ipc_wait(void* stream, void* word, unsigned int value) {
    if (int rc = load_driver()) return rc;
    return driver(g_wait32((CUstream)stream, (CUdeviceptr)word, value, CU_STREAM_WAIT_VALUE_GEQ));
}

extern "C" int sq_ipc_copy(void* dst, const void* src, size_t bytes, void* stream) {
    return (int)cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault, (cudaStream_t)stream);
}
