// K3: order-preserving compaction of the active cubes on Hopper, one pass.
//
// Replaces gsdf_tpu/ops/mc_emit.py::compact_indices / compact_indices_
// blocks (:190-288), which XLA fused on the TPU as a (two-level) sort.
// Input: the u8 case grid of K1 (or of the staged classification), 0 for
// an inactive cube. Outputs:
//   ids          int32, the ascending ids of the non-zero bytes;
//   offsets      int64, the crossing owner edges (n_cross, gsdf_scan.cuh)
//                of the active cubes before every 256th active rank: the
//                block offsets of K4's t values and of K7w's vertices;
//   tri_offsets  int64, the triangles (MC_TRI_COUNT[case]) before every
//                256th active rank: the block offsets of K7s and K7w;
//   counts       int64[3], (active cubes, crossing owner edges, triangles);
//   edge_ranks   int32, only where asked for (K7w's owner lookup): the
//                crossing owner edges before every 32nd cube of the grid,
//                and their total as the last entry.
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
// edges by bit tricks; triangles from the count table in shared memory,
// looked up only for the non-zero words, which are few); one block scan of
// the three counts packed in a 64-bit word, the tile's sums published,
// the sums of the tiles before it looked up. Then each warp writes its ids
// with neighbouring lanes on neighbouring ids, one round per thread that
// holds an active byte (a loop of scattered stores per thread was the
// slowest stage by far on the dense tiles of a part's flat faces). The
// offsets cost ballots only in a round that holds a 256th rank. The
// wrapper reads `counts` once; K4, K7s and K7w need no count pass of
// their own.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_mc_tables.cuh"
#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = 8;  // 4-byte words of case bytes per thread: two 16-byte loads
constexpr int kBytes = 4 * kWords;
static_assert(kBytes == 32, "a write round takes one thread's bytes, a lane each");
static_assert(kBytes == gsdf::kRankChunk, "a thread's bytes are one chunk of edge_ranks");
constexpr long long kTile = (long long)kThreads * kBytes;
constexpr int kEmitBlock = 256;  // active cubes per block of K4, K7s, K7w

// A thread's three counts in one 64-bit word for the block scan; a tile of
// 32,768 cubes holds at most 98,304 edges and 163,840 triangles.
constexpr int kEdgeShift = 20, kTriShift = 41;
constexpr long long kActiveMask = (1LL << kEdgeShift) - 1;
constexpr long long kEdgeMask = (1LL << (kTriShift - kEdgeShift)) - 1;
static_assert(kTile <= kActiveMask && 3 * kTile <= kEdgeMask && 5 * kTile < (1LL << 22),
              "a tile's sums fit their fields");

__device__ __forceinline__ void unpack(long long packed, long long* v) {
    v[0] = packed & kActiveMask;
    v[1] = (packed >> kEdgeShift) & kEdgeMask;
    v[2] = packed >> kTriShift;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ cases, long long n, long long tiles,
               unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
               int32_t* __restrict__ ids, long long* __restrict__ offsets,
               long long* __restrict__ tri_offsets, long long* __restrict__ counts,
               int32_t* __restrict__ edge_ranks) {
    __shared__ long long warp_sums[kThreads / 32];
    __shared__ long long tile_s, excl_s[gsdf::kSums];
    __shared__ uint8_t tri_count[256];
    if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
    if (threadIdx.x < 256) tri_count[threadIdx.x] = kTriCount[threadIdx.x];
    __syncthreads();
    const long long tile = tile_s;
    const long long base = tile * kTile + (long long)threadIdx.x * kBytes;
    uint32_t w[kWords];
#pragma unroll
    for (int q = 0; q < kWords; q += 4) gsdf::load16(cases, n, base + 4 * q, w + q);
    long long active = 0, edges = 0, ntris = 0;
    uint32_t any = 0;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
        any |= w[q];
        active += __popc(__vcmpne4(w[q], 0u)) >> 3;  // 0xff per non-zero byte
        edges += gsdf::word_edges(w[q]);  // 0 for an inactive cube (case 0)
        if (w[q])  // most words are empty: no lookup there
            ntris += tri_count[w[q] & 0xffu] + tri_count[(w[q] >> 8) & 0xffu] +
                     tri_count[(w[q] >> 16) & 0xffu] + tri_count[w[q] >> 24];
    }
    // one scan of the three counts
    long long total;
    const long long pre = gsdf::block_exclusive_scan<kThreads>(
        ntris << kTriShift | edges << kEdgeShift | active, &total, warp_sums);
    if (threadIdx.x < 32) {
        long long agg[gsdf::kSums], excl[gsdf::kSums] = {0, 0, 0};
        unpack(total, agg);
        if (tile == 0) {
            if (threadIdx.x == 0) gsdf::publish(status, tiles, 0, gsdf::kPrefix, agg);
        } else {
            if (threadIdx.x == 0) gsdf::publish(status, tiles, tile, gsdf::kAggregate, agg);
            gsdf::look_back(status, tiles, tile, excl);
        }
        if (threadIdx.x == 0) {
#pragma unroll
            for (int s = 0; s < gsdf::kSums; ++s) {
                excl_s[s] = excl[s];
                agg[s] += excl[s];  // the inclusive prefix
            }
            if (tile != 0) gsdf::publish(status, tiles, tile, gsdf::kPrefix, agg);
            if (tile == tiles - 1) {
#pragma unroll
                for (int s = 0; s < gsdf::kSums; ++s) counts[s] = agg[s];
                if (edge_ranks != nullptr)  // the directory's last entry: the total
                    edge_ranks[(n + kBytes - 1) / kBytes] = (int32_t)agg[1];
            }
        }
    }
    __syncthreads();
    // excl_s[s] + the field s of a thread's `pre`: the sums before its bytes
    if (edge_ranks != nullptr && base < n)
        edge_ranks[base / kBytes] = (int32_t)(excl_s[1] + ((pre >> kEdgeShift) & kEdgeMask));
    // Write, warp by warp, so that neighbouring lanes store neighbouring
    // ids: each round takes the next thread of the warp that loaded an
    // active byte, a lane for each of its bytes (fetched by shuffles, with
    // the sums before them); a ballot gives each active lane its rank.
    // Threads with no active byte (most of them) cost nothing.
    const unsigned lane = threadIdx.x & 31u;
    const unsigned below = (1u << lane) - 1u;
    unsigned left = __ballot_sync(0xffffffffu, any != 0u);
    while (left) {  // warp-uniform
        const int src = __ffs(left) - 1;
        left &= left - 1u;
        uint32_t word = 0;
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
            const uint32_t v = __shfl_sync(0xffffffffu, w[q], src);
            if (q == (int)lane / 4) word = v;
        }
        const unsigned c = (word >> (8 * (lane % 4))) & 0xffu;
        const unsigned act = __ballot_sync(0xffffffffu, c != 0u);
        const long long before = __shfl_sync(0xffffffffu, pre, src);  // the source's sums
        const long long p = excl_s[0] + (before & kActiveMask) + __popc(act & below);
        if (c) ids[p] = (int32_t)(base + ((long long)src - lane) * kBytes + lane);
        // the block offsets: only a round that holds a 256th active rank
        const bool first = c != 0u && p % kEmitBlock == 0;
        if (__any_sync(0xffffffffu, first)) {
            const unsigned e = gsdf::n_cross(c);  // 0-3 edges: two ballots
            const unsigned t = tri_count[c];      // 0-5 triangles: three
            const unsigned e1 = __ballot_sync(0xffffffffu, e & 1u);
            const unsigned e2 = __ballot_sync(0xffffffffu, e & 2u);
            const unsigned t1 = __ballot_sync(0xffffffffu, t & 1u);
            const unsigned t2 = __ballot_sync(0xffffffffu, t & 2u);
            const unsigned t4 = __ballot_sync(0xffffffffu, t & 4u);
            const long long epos = excl_s[1] + ((before >> kEdgeShift) & kEdgeMask);
            const long long tpos = excl_s[2] + (before >> kTriShift);
            if (first) {
                offsets[p / kEmitBlock] = epos + __popc(e1 & below) + 2 * __popc(e2 & below);
                tri_offsets[p / kEmitBlock] = tpos + __popc(t1 & below) +
                                              2 * __popc(t2 & below) + 4 * __popc(t4 & below);
            }
        }
    }
}

}  // namespace

// The int64 work buffer for n case bytes: counts (4, the last unused),
// offsets and tri_offsets (n / 256 + 1 each), the tiles' status words
// (3 per tile), the ticket. -1 if n is out of range.
extern "C" long long gsdf_compact_work(long long n) {
    const long long tiles = gsdf::blocks_for(n, kTile);
    if (n <= 0 || n > 0x7fffffffLL || tiles < 0) return -1;
    return 4 + 2 * (n / kEmitBlock + 1) + gsdf::kSums * tiles + 1;
}

// Clears the status words and the ticket, then launches the pass, both on
// `stream`; ids holds n entries, edge_ranks ceil(n / 32) + 1 or is null. Returns
// cudaGetLastError() (0 = launched).
extern "C" int gsdf_compact_active(const uint8_t* cases, long long n, long long* work,
                                   int32_t* ids, int32_t* edge_ranks, void* stream) {
    const long long tiles = gsdf::blocks_for(n, kTile);
    if (n <= 0 || n > 0x7fffffffLL || tiles < 0) return (int)cudaErrorInvalidValue;
    const long long blocks = n / kEmitBlock + 1;
    long long* counts = work;
    long long* offsets = work + 4;
    long long* tri_offsets = offsets + blocks;
    unsigned long long* status = reinterpret_cast<unsigned long long*>(tri_offsets + blocks);
    const cudaStream_t s = (cudaStream_t)stream;
    int rc = (int)cudaMemsetAsync(status, 0,
                                  (gsdf::kSums * tiles + 1) * sizeof(unsigned long long), s);
    if (rc != 0) return rc;
    unsigned* ticket = reinterpret_cast<unsigned*>(status + gsdf::kSums * tiles);
    compact_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(cases, n, tiles, status, ticket, ids,
                                                         offsets, tri_offsets, counts,
                                                         edge_ranks);
    return (int)cudaGetLastError();
}
