// Hand-written scans and edge arithmetic shared by the marching-cubes
// kernels (K3, K4, K7s, K7w). Every kernel that compacts follows one
// pattern of three launches:
//
//   1. count: each block sums its items' output counts into
//      block_sums[blockIdx.x];
//   2. scan_sums (this file): one block turns block_sums into exclusive
//      block offsets in place and writes the grand total;
//   3. write: each block recounts, scans its threads' counts
//      (block_exclusive_scan) and writes at block offset + thread prefix.
//
// Item order is kept: block b's items precede block b+1's, and a block's
// threads cover consecutive items. The wrapper reads the total between 2
// and 3 to allocate exact outputs (a device count, no grow-and-retry).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace gsdf {

// Exclusive scan of one value per thread over a block of kThreads threads
// (a multiple of 32, at most 1024). Returns this thread's prefix; *total
// gets the block's sum. warp_sums is shared scratch of kThreads/32 values.
// Every thread of the block must call it.
template <int kThreads, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total, T* warp_sums) {
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T w = lane < kWarps ? warp_sums[lane] : T(0);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += y;
        }
        if (lane < kWarps) warp_sums[lane] = w;
    }
    __syncthreads();
    const T before = warp > 0 ? warp_sums[warp - 1] : T(0);
    *total = warp_sums[kWarps - 1];
    __syncthreads();  // warp_sums is reused by the caller's next scan
    return before + x - v;
}

constexpr int kScanThreads = 1024;

// In-place exclusive scan of sums[0, n) by one block; *total = the sum.
// Each thread folds a contiguous run of ceil(n / 1024) entries.
__global__ void __launch_bounds__(kScanThreads)
scan_sums_kernel(long long* sums, long long n, long long* total) {
    __shared__ long long warp_sums[kScanThreads / 32];
    const long long per = (n + kScanThreads - 1) / kScanThreads;
    const long long lo = min(n, (long long)threadIdx.x * per);
    const long long hi = min(n, lo + per);
    long long s = 0;
    for (long long i = lo; i < hi; ++i) s += sums[i];
    long long all;
    long long run = block_exclusive_scan<kScanThreads>(s, &all, warp_sums);
    for (long long i = lo; i < hi; ++i) {
        const long long v = sums[i];
        sums[i] = run;
        run += v;
    }
    if (threadIdx.x == 0) *total = all;
}

inline int scan_sums(long long* sums, long long n, long long* total,
                     cudaStream_t stream) {
    scan_sums_kernel<<<1, kScanThreads, 0, stream>>>(sums, n, total);
    return (int)cudaGetLastError();
}

// Blocks of kThreads covering n items, or -1 past the grid's x limit.
inline long long blocks_for(long long n, long long per_block) {
    const long long b = (n + per_block - 1) / per_block;
    return b > 0x7fffffffLL ? -1 : b;
}

// Marching-cubes helpers on the case byte (bit k = sign of corner k).
// The owner (low) edges x, y, z of a cube join corner 0 to corners 1, 3
// and 4; an edge crosses where the two signs differ.
__device__ __forceinline__ unsigned cross_bits(unsigned c) {
    const unsigned b0 = c & 1u;
    return (b0 ^ ((c >> 1) & 1u)) | (b0 ^ ((c >> 3) & 1u)) << 1 |
           (b0 ^ ((c >> 4) & 1u)) << 2;
}

__device__ __forceinline__ int n_cross(unsigned c) { return __popc(cross_bits(c)); }

// The epsilon rules of mcInterpolate (marchcubes.go:76-98) on an edge from
// va to vb: t = (0 - va) / (vb - va), or 0.5 where both ends lie within
// 1e-12 of zero; ca / cb mark an end that does. The plain torch versions
// share ops/mc_emit.py::edge_t; every MC kernel interpolates through here.
struct EdgeT {
    float t;
    bool ca, cb;
};
__device__ __forceinline__ EdgeT mc_edge_t(float va, float vb) {
    EdgeT e;
    e.ca = fabsf(va) < 1e-12f;
    e.cb = fabsf(vb) < 1e-12f;
    e.t = (e.ca && e.cb) ? 0.5f : (0.0f - va) / (vb - va);
    return e;
}

// One coordinate of the edge point pa + t * (pb - pa), snapped to the end
// that lies within 1e-12 of zero (ops/mc_emit.py::lerp_edges).
__device__ __forceinline__ float mc_lerp(EdgeT e, float pa, float pb) {
    if (e.cb && !e.ca) return pb;
    if (e.ca && !e.cb) return pa;
    return pa + e.t * (pb - pa);
}

// Cube id -> (ci, cj, ck) for an (nz, ny, nx) cube grid, x fastest.
struct Cube {
    int i, j, k;
};
__device__ __forceinline__ Cube cube_of(long long id, int nx, int ny) {
    Cube c;
    c.i = (int)(id % nx);
    c.j = (int)((id / nx) % ny);
    c.k = (int)(id / ((long long)nx * ny));
    return c;
}

}  // namespace gsdf
