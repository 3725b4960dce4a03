// Hand-written scans, staged stores and edge arithmetic shared by the
// marching-cubes kernels (K3, K4, K7s, K7w). Item order is kept
// everywhere: block b's items precede block b+1's, and a block's threads
// cover consecutive items.
//
// - K3 (compact_active.cu) compacts in one pass, with decoupled look-back:
//   a block takes its tile from a ticket, publishes its tile's sums, finds
//   the sums of the tiles before it from their published words
//   (look_back), then writes at that prefix + thread prefix. Its three
//   running sums (active cubes, crossing owner edges, triangles) are what
//   the emit kernels need to size and place their outputs, so the wrapper
//   reads the totals once, after the pass, and K3 writes each sum's value
//   before every 256th active cube: the block offsets of K4, K7s and K7w.
// - K4, K7s and K7w run one block per 256 active cubes: a block scan of
//   the per-cube counts (block_exclusive_scan) on top of K3's block offset.
//   K7s and K7w stage a block's output in shared memory and write it as
//   consecutive words of the block's contiguous range (store_staged).
//
// Sizes come from K3's device counts: no count pass in the emit kernels,
// no grow-and-retry.
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

// --- decoupled look-back (single-pass scan across blocks) ---------------
// A tile's status is one 64-bit word per running sum (kSums of them, in
// arrays `tiles` words apart): the flag in the top two bits (0 = not yet
// published, kAggregate = the tile's own sum, kPrefix = the inclusive sum
// of every tile up to it), the value below. The words start at 0 (the
// wrapper clears them on the stream before each launch), and a tile waits
// only on tiles that took earlier tickets, which are already running, so
// the wait always ends. A tile publishes its words together, aggregates
// first and prefixes second: a reader takes a tile's words only when all
// carry the same flag.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kFlags = 3ull << 62;
constexpr int kSums = 3;

__device__ __forceinline__ void store_relaxed(unsigned long long* word, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* word) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
    return v;
}

// Tile `tile`'s words become flag | v[s], s < kSums.
__device__ __forceinline__ void publish(unsigned long long* status, long long tiles,
                                        long long tile, unsigned long long flag,
                                        const long long* v) {
    __threadfence();
#pragma unroll
    for (int s = 0; s < kSums; ++s)
        store_relaxed(status + s * tiles + tile, flag | (unsigned long long)v[s]);
}

// Exclusive prefixes excl[s] of tile `tile` over the words of tiles
// [0, tile), by one whole warp. Each lane reads one predecessor, nearest
// first, with relaxed loads that are all in flight together and one fence
// after them (an acquire load each would wait for the one before it), so
// a window of 32 tiles costs one round trip to L2; the window's words are
// summed up to the nearest kPrefix, else wholly, and the window moves
// back.
__device__ __forceinline__ void look_back(const unsigned long long* status, long long tiles,
                                          long long tile, long long* excl) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int s = 0; s < kSums; ++s) excl[s] = 0;
    for (long long end = tile;; end -= 32) {
        const long long p = end - 1 - lane;
        unsigned long long w[kSums];
        bool ready;
        do {
            ready = true;
#pragma unroll
            for (int s = 0; s < kSums; ++s) {
                // before tile 0: a prefix of 0
                w[s] = p >= 0 ? load_relaxed(status + s * tiles + p) : kPrefix;
                ready = ready && (w[s] & kFlags) != 0 && (w[s] & kFlags) == (w[0] & kFlags);
            }
        } while (!__all_sync(0xffffffffu, ready));
        __threadfence();  // acquire: the window's words before what follows
        const unsigned prefixes = __ballot_sync(0xffffffffu, (w[0] & kFlags) == kPrefix);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;  // the nearest prefix
#pragma unroll
        for (int s = 0; s < kSums; ++s) {
            long long v = lane <= stop ? (long long)(w[s] & ~kFlags) : 0;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
            excl[s] += v;
        }
        if (prefixes) break;
    }
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
            if (i < n) x |= (uint32_t)__ldg(cases + i) << (8 * b);
        }
        w[q] = x;
    }
}

// Crossing owner edges of the 4 cubes of a word of case bytes (n_cross
// per byte, all four at once): bit 0 of each byte against bits 1, 3 and
// 4. An inactive cube (case 0) has none.
constexpr uint32_t kLowBits = 0x01010101u;  // bit 0 of each byte
__device__ __forceinline__ int word_edges(uint32_t w) {
    const uint32_t b0 = w & kLowBits;
    return __popc(b0 ^ ((w >> 1) & kLowBits)) + __popc(b0 ^ ((w >> 3) & kLowBits)) +
           __popc(b0 ^ ((w >> 4) & kLowBits));
}

// --- the edge-rank directory (K3 writes it, K7w reads it) ---------------
// edge_ranks[i] = crossing owner edges of the active cubes with id below
// kRankChunk * i, for i up to ceil(cubes / kRankChunk), so the last entry
// is the total. An active cube's first welded vertex is that sum at its
// id: 4 B per 32 cubes take the place of a cube -> slot map of 4 B per
// cube. A lookup is two loads whose addresses depend on the id alone, the
// 16 case bytes around the cube and the directory entry at the nearer end
// of its chunk: forwards from the chunk's start in the lower half,
// backwards from the next chunk's in the upper. The cube's own case byte
// is among the 16, so nothing waits for it.
constexpr int kRankChunk = 32;

struct OwnerLoad {
    uint32_t w[4];  // the 16 case bytes of the cube's half chunk
    int rank;       // edge_ranks at the chunk's start (lower half) or end (upper)
};

__device__ __forceinline__ OwnerLoad owner_load(const uint8_t* cases, long long n,
                                                const int32_t* edge_ranks, long long id) {
    OwnerLoad l;
    load16(cases, n, id & ~15LL, l.w);
    l.rank = __ldg(edge_ranks + (id + kRankChunk / 2) / kRankChunk);
    return l;
}

__device__ __forceinline__ unsigned owner_case(const OwnerLoad& l, long long id) {
    const int p = (int)(id & 15);
    const uint32_t word = p < 4 ? l.w[0] : p < 8 ? l.w[1] : p < 12 ? l.w[2] : l.w[3];
    return (word >> (8 * (p & 3))) & 0xffu;
}

// Crossing owner edges of the active cubes before cube `id`.
__device__ __forceinline__ int owner_edges_before(const OwnerLoad& l, long long id) {
    const int p = (int)(id & 15);
    const bool upper = (id & (kRankChunk / 2)) != 0;
    int e = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int below = p - 4 * q;  // bytes of word q before the cube
        const uint32_t low = below >= 4 ? 0xffffffffu : below <= 0 ? 0u : (1u << (8 * below)) - 1u;
        e += word_edges(l.w[q] & (upper ? ~low : low));  // upper: the cube's byte and after
    }
    return upper ? l.rank - e : l.rank + e;
}

// --- staged stores -------------------------------------------------------
// A block's output is one contiguous range of 4-byte words at dst. The
// block builds it in shared memory and writes it out together, so that
// every store instruction of a warp covers consecutive addresses (a thread
// writing its own 36-byte triangles scatters a warp's stores over up to
// 32 x 180 B). Word i of the range sits at stage[shift + i], shift =
// stage_shift(dst): a 16-byte group of dst is then a 16-byte group of the
// stage, and the body goes out in 16-byte stores. stage is 16-byte
// aligned and holds the range's words + 4.
__device__ __forceinline__ int stage_shift(const void* dst) {
    return (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u);
}

// Every thread of the block calls it, after a __syncthreads() that
// follows the last write to the stage.
template <int kThreads>
__device__ __forceinline__ void store_staged(const uint32_t* stage, int shift, uint32_t* dst,
                                             int n) {
    const int head = min(n, (4 - shift) & 3);  // words before the first 16-byte group
    const int body = (n - head) / 4;           // whole groups
    if ((int)threadIdx.x < head) dst[threadIdx.x] = stage[shift + threadIdx.x];
    const uint4* s4 = reinterpret_cast<const uint4*>(stage + shift + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    for (int i = threadIdx.x; i < body; i += kThreads) d4[i] = s4[i];
    for (int i = head + 4 * body + threadIdx.x; i < n; i += kThreads) dst[i] = stage[shift + i];
}

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
