// What the cluster kernels share (field_kernel.cu: kernels 3 and 4 at B > 1;
// gauge_kernel.cu: kernels 10 and 11 at B > 1, kernel 12): one chain on a thread-block
// cluster of B blocks, block rank b owning a contiguous strip of lattice rows,
// launched with cudaLaunchKernelEx and a cluster-dimension attribute.
//
// Strips: rank b owns rows [b L0 / B, (b + 1) L0 / B) (integer division, so
// strips differ by at most one row and every rank owns at least one row when
// B <= L0); its shared-memory copy of the strip has one halo row above (local
// row 0) and one below (local row n + 1), so an owned row r0 + k is local row
// k + 1.  The Python mirror is kernels/_cluster.py (strips, smem sizes, the
// geometry rule).
//
// Reductions across the cluster are in a fixed order: each block reduces its
// partials in warp order into a slot of its own shared memory, a cluster
// barrier publishes the slots, threads 0 .. B-1 copy rank t's slot through
// distributed shared memory, and after a block barrier every thread combines
// the B slots in rank order.  No atomics: the result is the same on every run
// and in every thread of the cluster, so control flow stays cluster-uniform.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define SQ_MAX_CLUSTER 16

struct Strip {
    int rank, B;      // this block's rank, blocks of the cluster
    int r0, n;        // first owned global row, owned rows
    int up, n_up;     // rank owning the rows above (row r0 - 1) and its row count
    int dn;           // rank owning the rows below (row r0 + n)
};

__device__ __forceinline__ int strip_first(int b, int L0, int B) {
    return (int)(((long long)b * L0) / B);
}

__device__ __forceinline__ Strip make_strip(int rank, int B, int L0) {
    Strip s;
    s.rank = rank;
    s.B = B;
    s.r0 = strip_first(rank, L0, B);
    s.n = strip_first(rank + 1, L0, B) - s.r0;
    s.up = rank == 0 ? B - 1 : rank - 1;
    s.n_up = strip_first(s.up + 1, L0, B) - strip_first(s.up, L0, B);
    s.dn = rank + 1 == B ? 0 : rank + 1;
    return s;
}

// Global row of local row lr (0 .. n + 1) of a strip, with the periodic wrap.
__device__ __forceinline__ int strip_row(const Strip& s, int lr, int L0) {
    int r = s.r0 + lr - 1;
    return r < 0 ? r + L0 : (r >= L0 ? r - L0 : r);
}

// Set the attributes a cluster launch of `kern` needs (dynamic shared memory
// above 48 KB; clusters above the portable 8 blocks) and fill `cfg`.
template <typename... KArgs>
static cudaError_t cluster_config(void (*kern)(KArgs...), int grid, int threads, size_t smem,
                                  int B, cudaStream_t st, cudaLaunchConfig_t& cfg,
                                  cudaLaunchAttribute* attr) {
    cudaError_t e = cudaFuncSetAttribute((const void*)kern,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (B > 8) {
        e = cudaFuncSetAttribute((const void*)kern,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
    }
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)B;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
}

// Launch `kern` on n_chains clusters of B blocks; a refused launch returns its
// error (the wrapper raises), it never runs on fewer blocks.
template <typename... KArgs, typename... Args>
static cudaError_t launch_cluster(void (*kern)(KArgs...), int n_chains, int threads,
                                  size_t smem, int B, cudaStream_t st, Args... args) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = cluster_config(kern, n_chains * B, threads, smem, B, st, cfg, attr);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, kern, args...);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// Clusters of B blocks of `kern` the card holds at once (all SMs, each
// cluster inside one GPC), as cudaOccupancyMaxActiveClusters reports it.
template <typename... KArgs>
static cudaError_t resident_clusters(void (*kern)(KArgs...), int threads, size_t smem, int B,
                                     int* out) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cudaError_t e = cluster_config(kern, B, threads, smem, B, 0, cfg, attr);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveClusters(out, (const void*)kern, &cfg);
}

// Blocks of a one-block-per-chain kernel the card holds at once, with `smem`
// bytes of dynamic shared memory a block.
template <typename... KArgs>
static cudaError_t resident_blocks(void (*kern)(KArgs...), int threads, int* out,
                                   size_t smem = 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && smem > 48 * 1024)
        e = cudaFuncSetAttribute((const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)kern, threads,
                                                          smem);
    *out = sms * per_sm;
    return e;
}

// The cluster's fixed-order combination: `mine` (NV floats, this block's
// partials reduced in warp order, held by thread 0) goes into this block's
// slot; after the cluster barrier threads 0 .. B-1 copy rank t's slot into
// gath[t * NV ...] and a block barrier makes them every thread's.  The caller
// combines gath in rank order.
template <int NV>
__device__ __forceinline__ void cluster_gather(cg::cluster_group& cl, const float* mine,
                                               float* slot, float* gath, int B) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v) slot[v] = mine[v];
    }
    cl.sync();  // release / acquire at cluster scope: the slots and every DSMEM push
    if ((int)threadIdx.x < B) {
        const float* rs = cl.map_shared_rank(slot, (int)threadIdx.x);
#pragma unroll
        for (int v = 0; v < NV; ++v) gath[threadIdx.x * NV + v] = rs[v];
    }
    __syncthreads();
}
