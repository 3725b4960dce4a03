// K3: order-preserving compaction of the active cubes on Hopper, one pass.
//
// Replaces gsdf_tpu/ops/mc_emit.py::compact_indices / compact_indices_
// blocks (:190-288), which XLA fused on the TPU as a (two-level) sort.
// Input: the u8 case grid of K1 (or of the staged classification), 0 for
// an inactive cube. Outputs:
//   ids      int32, the ascending ids of the non-zero bytes;
//   offsets  int64, for K4: the number of crossing owner edges (n_cross,
//            gsdf_scan.cuh) of the active cubes before every 256th active
//            rank -- the block offsets of K4's emit kernel;
//   counts   int64[2], (active cubes, crossing owner edges).
//
// What bounds it on the card: the bytes, 1 per cube read and 4 per active
// cube written (52 MB and 7 MB at flange 800, 0.018 ms), but at the main
// path's sizes the latency of a block's stages and the launch take most of
// the time. The design reads each case byte once, in one launch (after a
// memset of the tile status), with a decoupled look-back across tiles
// (gsdf_scan.cuh). A block of 1024 threads takes its tile of 32 KB from a
// ticket, so every tile it waits on is already running (few tiles keep
// the look-back chain short: 201 at flange 400, 1,600 at flange 800). Each
// thread loads 32 consecutive bytes in 16-byte loads where aligned and
// counts four cubes at a time in a 32-bit word (active bytes and crossing
// edges by bit tricks); one block scan of the (active, edge) counts packed
// in a 64-bit word, the tile's sums published, the sums of the tiles
// before it looked up. Then each warp writes its ids with neighbouring
// lanes on neighbouring ids (ballots), visiting only the threads that hold
// an active byte (a loop of scattered stores per thread was the slowest
// stage by far on the dense tiles of a part's flat faces). The wrapper reads `counts` once; K4
// needs no count pass of its own.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = 8;  // 4-byte words of case bytes per thread: two 16-byte loads
constexpr int kBytes = 4 * kWords;
constexpr int kSources = 32 / kBytes;  // threads whose bytes one write round takes
static_assert(kBytes <= 32 && 32 % kBytes == 0, "a write round spans whole threads");
constexpr long long kTile = (long long)kThreads * kBytes;
constexpr int kEmitBlock = 256;  // active cubes per K4 emit block
constexpr uint32_t kLow = 0x01010101u;  // bit 0 of each byte

// 16 case bytes at `base` as 4 little-endian words, 0 past n: one 16-byte
// load where aligned and whole.
__device__ __forceinline__ void load16(const uint8_t* cases, long long n, long long base,
                                       uint32_t* w) {
    if (base + 16 <= n && ((reinterpret_cast<uintptr_t>(cases) + (uintptr_t)base) & 15) == 0) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(cases + base));
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

// Crossing owner edges of the 4 cubes of a word (gsdf::n_cross per byte,
// all four at once): bit 0 of each byte against bits 1, 3 and 4.
__device__ __forceinline__ int word_edges(uint32_t w) {
    const uint32_t b0 = w & kLow;
    return __popc(b0 ^ ((w >> 1) & kLow)) + __popc(b0 ^ ((w >> 3) & kLow)) +
           __popc(b0 ^ ((w >> 4) & kLow));
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ cases, long long n, long long tiles,
               unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
               int32_t* __restrict__ ids, long long* __restrict__ offsets,
               long long* __restrict__ counts) {
    __shared__ long long warp_sums[kThreads / 32];
    __shared__ long long tile_s, excl_active, excl_edges;
    if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = tile_s;
    const long long base = tile * kTile + (long long)threadIdx.x * kBytes;
    uint32_t w[kWords];
#pragma unroll
    for (int q = 0; q < kWords; q += 4) load16(cases, n, base + 4 * q, w + q);
    long long active = 0, edges = 0;
    uint32_t any = 0;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
        any |= w[q];
        active += __popc(__vcmpne4(w[q], 0u)) >> 3;  // 0xff per non-zero byte
        edges += word_edges(w[q]);  // 0 for an inactive cube (case 0)
    }
    // one scan of both counts: a tile's sums stay below 2^32 each
    long long total;
    const long long pre =
        gsdf::block_exclusive_scan<kThreads>(edges << 32 | active, &total, warp_sums);
    const long long agg_active = total & 0xffffffffLL, agg_edges = total >> 32;
    unsigned long long* st_active = status;
    unsigned long long* st_edges = status + tiles;
    if (threadIdx.x < 32) {
        long long ea = 0, ee = 0;
        if (tile == 0) {
            if (threadIdx.x == 0)
                gsdf::publish(st_active, st_edges, 0, gsdf::kPrefix, agg_active, agg_edges);
        } else {
            if (threadIdx.x == 0)
                gsdf::publish(st_active, st_edges, tile, gsdf::kAggregate, agg_active, agg_edges);
            gsdf::look_back(st_active, st_edges, tile, &ea, &ee);
            if (threadIdx.x == 0)
                gsdf::publish(st_active, st_edges, tile, gsdf::kPrefix, ea + agg_active,
                              ee + agg_edges);
        }
        if (threadIdx.x == 0) {
            excl_active = ea;
            excl_edges = ee;
            if (tile == tiles - 1) {
                counts[0] = ea + agg_active;
                counts[1] = ee + agg_edges;
            }
        }
    }
    __syncthreads();
    // Write, warp by warp, so that neighbouring lanes store neighbouring
    // ids: each round takes the next kSources threads of the warp that
    // loaded an active byte, kBytes lanes for each thread's bytes (fetched
    // by shuffles); ballots give each active lane its rank. Threads with no
    // active byte (most of them) cost nothing.
    const unsigned lane = threadIdx.x & 31u;
    const unsigned below = (1u << lane) - 1u;
    const long long warp_pre = __shfl_sync(0xffffffffu, pre, 0);
    long long pos = excl_active + (warp_pre & 0xffffffffLL);
    long long epos = excl_edges + (warp_pre >> 32);
    const long long warp_base = base - (long long)lane * kBytes;
    unsigned left = __ballot_sync(0xffffffffu, any != 0u);
    while (left) {  // warp-uniform
        const int slot = (int)lane / kBytes, at = (int)lane % kBytes;
        const int first = __ffs(left) - 1;
        int src = -1;
#pragma unroll
        for (int j = 0; j < kSources; ++j) {  // the next kSources threads, in order
            if (j == slot && left) src = __ffs(left) - 1;
            left &= left - 1u;
        }
        const bool idle = src < 0;
        if (idle) src = first;  // a valid shuffle source; the lane takes no byte
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
            const uint32_t v = __shfl_sync(0xffffffffu, w[q], src);
            if (q == at / 4) word = v;
        }
        const unsigned c = idle ? 0u : (word >> (8 * (at % 4))) & 0xffu;
        const unsigned e = gsdf::n_cross(c);  // 0-3 edges: two ballots
        const unsigned act = __ballot_sync(0xffffffffu, c != 0u);
        const unsigned e1 = __ballot_sync(0xffffffffu, e & 1u);
        const unsigned e2 = __ballot_sync(0xffffffffu, e & 2u);
        if (c) {
            const long long p = pos + __popc(act & below);
            ids[p] = (int32_t)(warp_base + (long long)src * kBytes + at);
            if (p % kEmitBlock == 0)
                offsets[p / kEmitBlock] = epos + __popc(e1 & below) + 2 * __popc(e2 & below);
        }
        pos += __popc(act);
        epos += __popc(e1) + 2 * __popc(e2);
    }
}

}  // namespace

// The int64 work buffer for n case bytes: counts (2), K4's offsets
// (n / 256 + 1), the tiles' status words (2 per tile), the ticket. -1 if
// n is out of range.
extern "C" long long gsdf_compact_work(long long n) {
    const long long tiles = gsdf::blocks_for(n, kTile);
    if (n <= 0 || n > 0x7fffffffLL || tiles < 0) return -1;
    return 2 + (n / kEmitBlock + 1) + 2 * tiles + 1;
}

// Clears the status words and the ticket, then launches the pass, both on
// `stream`; ids holds n entries. Returns cudaGetLastError() (0 = launched).
extern "C" int gsdf_compact_active(const uint8_t* cases, long long n, long long* work,
                                   int32_t* ids, void* stream) {
    const long long tiles = gsdf::blocks_for(n, kTile);
    if (n <= 0 || n > 0x7fffffffLL || tiles < 0) return (int)cudaErrorInvalidValue;
    long long* counts = work;
    long long* offsets = work + 2;
    unsigned long long* status =
        reinterpret_cast<unsigned long long*>(offsets + n / kEmitBlock + 1);
    const cudaStream_t s = (cudaStream_t)stream;
    int rc = (int)cudaMemsetAsync(status, 0, (2 * tiles + 1) * sizeof(unsigned long long), s);
    if (rc != 0) return rc;
    unsigned* ticket = reinterpret_cast<unsigned*>(status + 2 * tiles);
    compact_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(cases, n, tiles, status, ticket, ids,
                                                         offsets, counts);
    return (int)cudaGetLastError();
}
