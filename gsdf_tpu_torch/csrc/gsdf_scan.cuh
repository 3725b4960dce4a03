// Hand-written scans and edge arithmetic shared by the marching-cubes
// kernels (K3, K4, K7s, K7w). Item order is kept everywhere: block b's
// items precede block b+1's, and a block's threads cover consecutive
// items. Two ways to compact:
//
// - K3 (compact_active.cu) in one pass, with decoupled look-back: a block
//   takes its tile from a ticket, publishes its tile's sum, finds the sum
//   of the tiles before it from their published words (look_back), then
//   writes at that prefix + thread prefix. The wrapper reads the totals
//   once, after the pass, and hands K4 the offsets K3 wrote for it.
// - K7s and K7w in three launches:
//   1. count: each block sums its items' output counts into
//      block_sums[blockIdx.x];
//   2. scan_sums: one block turns block_sums into exclusive block
//      offsets in place and writes the grand total;
//   3. write: each block recounts, scans its threads' counts
//      (block_exclusive_scan) and writes at block offset + thread prefix;
//   the wrapper reads the total between 2 and 3 to allocate exactly.
//
// Either way sizes come from a device count: no grow-and-retry.
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

// --- decoupled look-back (single-pass scan across blocks) ---------------
// A tile's status is one 64-bit word per running sum: the flag in the top
// two bits (0 = not yet published, kAggregate = the tile's own sum,
// kPrefix = the inclusive sum of every tile up to it), the value below.
// The words start at 0 (the wrapper clears them on the stream before each
// launch), and a tile waits only on tiles that took earlier tickets, which
// are already running, so the wait always ends. A tile publishes its
// words as a pair, aggregates first and prefixes second: a reader takes a
// tile's pair only when both words carry the same flag.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kFlags = 3ull << 62;

__device__ __forceinline__ void store_relaxed(unsigned long long* word, unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* word) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
    return v;
}

// Tile `tile`'s two words (in arrays a and b) become flag | va and flag | vb.
__device__ __forceinline__ void publish(unsigned long long* a, unsigned long long* b,
                                        long long tile, unsigned long long flag, long long va,
                                        long long vb) {
    __threadfence();
    store_relaxed(a + tile, flag | (unsigned long long)va);
    store_relaxed(b + tile, flag | (unsigned long long)vb);
}

// Exclusive prefixes (*ea, *eb) of tile `tile` over the word pairs of
// tiles [0, tile), by one whole warp. Each lane reads one predecessor,
// nearest first, with relaxed loads that are all in flight together and
// one fence after them (an acquire load each would wait for the one
// before it), so a window of 32 tiles costs one round trip to L2; the
// window's pairs are summed up to the nearest kPrefix, else wholly, and
// the window moves back.
__device__ __forceinline__ void look_back(const unsigned long long* a,
                                          const unsigned long long* b, long long tile,
                                          long long* ea, long long* eb) {
    const int lane = threadIdx.x & 31;
    long long sa = 0, sb = 0;
    for (long long end = tile;; end -= 32) {
        const long long p = end - 1 - lane;
        unsigned long long wa, wb;
        do {
            wa = p >= 0 ? load_relaxed(a + p) : kPrefix;  // before tile 0: a prefix of 0
            wb = p >= 0 ? load_relaxed(b + p) : kPrefix;
        } while (!__all_sync(0xffffffffu,
                             (wa & kFlags) != 0 && (wa & kFlags) == (wb & kFlags)));
        __threadfence();  // acquire: the window's words before what follows
        const unsigned prefixes = __ballot_sync(0xffffffffu, (wa & kFlags) == kPrefix);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;  // the nearest prefix
        long long va = lane <= stop ? (long long)(wa & ~kFlags) : 0;
        long long vb = lane <= stop ? (long long)(wb & ~kFlags) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            va += __shfl_xor_sync(0xffffffffu, va, o);
            vb += __shfl_xor_sync(0xffffffffu, vb, o);
        }
        sa += va;
        sb += vb;
        if (prefixes) break;
    }
    *ea = sa;
    *eb = sb;
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
