// K3: order-preserving compaction of the active cubes on Hopper.
//
// Replaces gsdf_tpu/ops/mc_emit.py::compact_indices / compact_indices_
// blocks (:190-288), which XLA fused on the TPU as a (two-level) sort.
// Input: the u8 case grid of K1 (or of the staged classification), 0 for
// an inactive cube. Output: the ascending int32 ids of the non-zero bytes
// and their count. Three launches (gsdf_scan.cuh): a block count, an
// exclusive scan of the block sums, then a block-local scan and scatter.
//
// What bounds it on the card: reading the case grid twice (1 B per cube
// per pass; 52 MB at flange 800) and writing 4 B per active cube. Each
// thread reads 16 consecutive bytes with one 16-byte load where aligned,
// so a block covers 4096 cubes and the block-sum scan stays small.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // case bytes per thread: one 16-byte load
constexpr long long kTile = (long long)kThreads * kItems;

// The thread's kItems case bytes as 4 little-endian words, 0 past n.
__device__ __forceinline__ void load_bytes(const uint8_t* cases, long long n,
                                           long long base, uint32_t w[4]) {
    if (base + kItems <= n &&
        ((reinterpret_cast<uintptr_t>(cases) + (uintptr_t)base) & 15) == 0) {
        const uint4 v = *reinterpret_cast<const uint4*>(cases + base);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
        return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            const long long i = base + q * 4 + b;
            if (i < n) x |= (uint32_t)cases[i] << (8 * b);
        }
        w[q] = x;
    }
}

__device__ __forceinline__ long long count_nonzero(const uint32_t w[4]) {
    int c = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) c += ((w[q] >> (8 * b)) & 0xffu) != 0;
    }
    return c;
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ cases, long long n,
             long long* __restrict__ block_sums) {
    __shared__ long long warp_sums[kThreads / 32];
    const long long base = blockIdx.x * kTile + (long long)threadIdx.x * kItems;
    uint32_t w[4];
    load_bytes(cases, n, base, w);
    long long total;
    gsdf::block_exclusive_scan<kThreads>(count_nonzero(w), &total, warp_sums);
    if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ cases, long long n,
               const long long* __restrict__ block_offsets,
               int32_t* __restrict__ ids) {
    __shared__ long long warp_sums[kThreads / 32];
    const long long base = blockIdx.x * kTile + (long long)threadIdx.x * kItems;
    uint32_t w[4];
    load_bytes(cases, n, base, w);
    long long total;
    long long pos = block_offsets[blockIdx.x] +
        gsdf::block_exclusive_scan<kThreads>(count_nonzero(w), &total, warp_sums);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
            if ((w[q] >> (8 * b)) & 0xffu) ids[pos++] = (int32_t)(base + q * 4 + b);
        }
    }
}

}  // namespace

// int64 scratch entries (block sums) for n case bytes; -1 if too many.
extern "C" long long gsdf_compact_blocks(long long n) {
    return gsdf::blocks_for(n, kTile);
}

// Launches 1 and 2 on `stream`: block_sums becomes the block offsets,
// *count the number of active cubes. Returns cudaGetLastError().
extern "C" int gsdf_compact_count(const uint8_t* cases, long long n,
                                  long long* block_sums, long long* count,
                                  void* stream) {
    const long long blocks = gsdf::blocks_for(n, kTile);
    if (n <= 0 || n > 0x7fffffffLL || blocks < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(cases, n, block_sums);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    return gsdf::scan_sums(block_sums, blocks, count, s);
}

// Launch 3: ids (count entries) of the non-zero bytes, ascending.
extern "C" int gsdf_compact_scatter(const uint8_t* cases, long long n,
                                    const long long* block_offsets,
                                    int32_t* ids, void* stream) {
    const long long blocks = gsdf::blocks_for(n, kTile);
    if (n <= 0 || n > 0x7fffffffLL || blocks < 0) return (int)cudaErrorInvalidValue;
    scatter_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        cases, n, block_offsets, ids);
    return (int)cudaGetLastError();
}
