// K5: dual contouring's device stage on Hopper, from the tree to one
// vertex per surface voxel.
//
// Replaces gsdf_tpu/render/dual_contour.py::dc_mesh_emit (:179-508) and
// the edge field of _dc_edges_fn (:61-135), which XLA fused on the TPU
// around a dense grid eval (pallas_grid_eval_fn's work, :575-583). The
// JAX code sorts the 5 contributions of every active edge by voxel (an
// argsort over 5A entries) and segment-sums them; here a voxel GATHERS
// its rows instead. A voxel receives rows only from the at most 15 edges
// at fixed offsets from it (ops/dc_tables.py GATHER), so a voxel is live
// if and only if one of those edges is active, and the order in which the
// JAX package sums a voxel's rows (edge id, then the position in OFF5) is
// the same static order for every voxel.
//
// Two calls, with the wrapper's one read of the counts between them:
//   gsdf_dc_count: (a) eval: every corner's distance, K1's eval pass
//     (one thread per corner, corner plane in blockIdx.y), positions
//     origin + (float)(global index) * res: K2's values bit for bit; it
//     also zeroes the work words (the scan's status words and ticket), so
//     no memset runs;
//     (b) flags: each voxel of the edge space tests its three edges (sign
//     bits of the ends) and a warp's ballot per axis is stored: 4 B per
//     32 voxels and axis (`ebits`), no scan. A warp takes kFlagWords
//     words: one division set per word, not per voxel;
//     (c) scan: one pass over the 32-voxel words with one decoupled
//     look-back (gsdf_scan.cuh), a thread per word: the word's rank among
//     its axis's active edges (`edir`, the popcounts of the axis words
//     before it), its live word (the OR of 12 shifted ballot words,
//     masked at row, plane and owned-layer ends: gsdf_dc_words.cuh), the
//     ascending live voxel ids (`uvox`) and, from the last tile, the three
//     axis totals and the live count;
//   gsdf_dc_emit, at the exact counts:
//     (d) edges: a warp per 32 words lists their voxels with an active
//     edge in shared memory (a warp scan of the words' counts) and writes
//     each listed voxel's active edges, 32 voxels at a time, at their
//     ranks (axis base + word rank + bits below): id axis*nvox + voxel, t,
//     flip and the crossing point;
//     (e) normals: one thread per tree evaluation, 6 per edge at the
//     point +- half a step on each axis; the + and - evaluations of an
//     axis sit in neighbouring lanes and the + lane writes their
//     difference times `scale` (a shuffle): six times the warps of a
//     thread per edge, the same floats;
//     (f) qef: one thread per live voxel gathers its rows (an edge's slot
//     from its ballot word and rank; the loads of all 15 rows in a few
//     rounds), sums the 13 columns in the static order, solves
//     (gsdf_qef.cuh) and places the vertex.
//
// What bounds it on the card: the ALU, on the tree at every corner and 6
// times at every active edge (gsdf_tpu_torch/bounds.py); the bytes, 4 per
// corner written and read back, are far below. The QEF's 5 Jacobi sweeps
// (45 precise transcendentals a voxel) are a few percent of it. (b)-(d)
// do no floating-point work: they read the grid once and about 40 B per
// 32 voxels, so they are latency-bound: each is one pass over words, not
// voxels, with its loads in flight together (PERF.md).
//
// Slabs: k0 is the slab's first corner plane in the whole grid and enters
// position synthesis only; n_own (<= the slab's edge layers) limits the
// owned voxels, so a halo layer's edges give rows to owned voxels without
// claiming the next slab's (gsdf_tpu/parallel/sharded_dc.py:148-333).
// Edge ids stay slab-local.
//
// The parametric form, K5p (gsdf_params.cuh): (a) and (e) call a
// parametric gsdf_tree() that reads the tree's continuous parameters from
// the kernels' last argument; both entry points take the vector.
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py,
// gsdf_dc_tables.cuh by gsdf_tpu_torch/ops/dc_tables.py. Built with
// -fmad=false, -prec-div=true, -prec-sqrt=true.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"
#include "gsdf_params.cuh"
#include "gsdf_scan.cuh"
#include "gsdf_qef.cuh"
#include "gsdf_dc_words.cuh"
#include "gsdf_dc_tables.cuh"

namespace {

using gsdf_dcw::Space;

constexpr int kEvalThreads = 256;
constexpr int kFlagThreads = 256;
constexpr int kFlagWords = 4;  // consecutive 32-voxel words per flag warp
constexpr int kScanThreads = 1024;  // a tile: one 32-voxel word a thread
// A word's and a tile's four counts (x, y, z edges, live voxels), packed
// in 16-bit fields for the block scan: each stays below 32 * kScanThreads.
constexpr int kField = 16;
static_assert(32 * kScanThreads < (1 << kField), "a tile's counts fit their fields");
constexpr unsigned long long kFieldMask = (1ull << kField) - 1;
// Across tiles the x and y totals share one status sum, 31 bits each
// (every total is below 2^30: shape_ok), z and the live count one each.
constexpr int kPair = 31;
constexpr long long kPairMask = (1LL << kPair) - 1;
constexpr int kEdgeThreads = 256;  // a warp per 32 consecutive words
constexpr int kNormalThreads = 128;
constexpr int kQefThreads = 128;

__global__ void __launch_bounds__(kEvalThreads)
eval_kernel(float* __restrict__ dist, float ox, float oy, float oz, float res, int k0, int nj,
            int ni, long long* __restrict__ work, long long n_work GSDF_PARAMS_DECL) {
    const unsigned plane = (unsigned)nj * (unsigned)ni;
    const unsigned c = blockIdx.x * kEvalThreads + threadIdx.x;
    if (c >= plane) return;
    const long long at = (long long)blockIdx.y * plane + c;
    if (at < n_work) work[at] = 0;
    const int j = (int)(c / (unsigned)ni);
    const int i = (int)(c - (unsigned)j * (unsigned)ni);
    const int k = (int)blockIdx.y;
    float p[3];
    gsdf_dc::corner_position(ox, oy, oz, res, i, j, k0 + k, p);
    dist[(long long)k * plane + c] = GSDF_TREE(p[0], p[1], p[2]);
}

// A voxel's (i, j, k) from its id, v < 2^31 (shape_ok): 32-bit division.
struct Voxel {
    int i, j, k;
};
__device__ __forceinline__ Voxel voxel_of(long long v, const Space& s) {
    const unsigned u = (unsigned)v, row = u / (unsigned)s.nx;
    Voxel x;
    x.i = (int)(u - row * (unsigned)s.nx);
    x.j = (int)(row % (unsigned)s.ny);
    x.k = (int)(row / (unsigned)s.ny);
    return x;
}

// (b) the edge flags: a warp per kFlagWords consecutive words, a lane per
// voxel of each. Lane r < kFlagWords finds word r's first voxel (i, j, k)
// by division and the warp shares it, so a voxel costs a carry, not two
// divisions; a word's loads are all in flight before the ballots, and
// lane r stores word r's three ballots.
__global__ void __launch_bounds__(kFlagThreads)
flags_kernel(const float* __restrict__ dist, Space s, uint32_t* __restrict__ ebits) {
    const int lane = threadIdx.x & 31;
    const long long w0 = (((long long)blockIdx.x * kFlagThreads + threadIdx.x) >> 5) * kFlagWords;
    const long long v_first = 32 * (w0 + lane % kFlagWords);
    const Voxel first = voxel_of(v_first < s.nvox ? v_first : s.nvox - 1, s);
    const long long ni = s.nx + 1, cplane = ni * (s.ny + 1);
    bool act[kFlagWords][3];
#pragma unroll
    for (int r = 0; r < kFlagWords; ++r) {
        int i = __shfl_sync(0xffffffffu, first.i, r) + lane;
        int j = __shfl_sync(0xffffffffu, first.j, r), k = __shfl_sync(0xffffffffu, first.k, r);
        while (i >= s.nx) {  // at most once where a row is 32 voxels or more
            i -= s.nx;
            if (++j == s.ny) {
                j = 0;
                ++k;
            }
        }
        act[r][0] = act[r][1] = act[r][2] = false;
        if (32 * (w0 + r) + lane < s.nvox) {
            const float* c0 = dist + k * cplane + j * ni + i;
            const float d0 = c0[0];
            act[r][0] = gsdf_dc::edge_active(d0, c0[1]);
            act[r][1] = gsdf_dc::edge_active(d0, c0[ni]);
            act[r][2] = gsdf_dc::edge_active(d0, c0[cplane]);
        }
    }
    uint32_t mine[3] = {0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < kFlagWords; ++r)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const uint32_t word = __ballot_sync(0xffffffffu, act[r][a]);
            if (lane == r) mine[a] = word;
        }
    if (lane < kFlagWords && w0 + lane < s.words) {
#pragma unroll
        for (int a = 0; a < 3; ++a) ebits[a * s.words + w0 + lane] = mine[a];
    }
}

// (c) one scan over the words: ranks, live words, live ids, counts. A
// thread takes one word, so thread order is word order and one block scan
// gives every word's offset in the tile.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const uint32_t* __restrict__ ebits, Space s, long long tiles,
            unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
            int32_t* __restrict__ edir, int32_t* __restrict__ uvox,
            long long* __restrict__ counts) {
    __shared__ unsigned long long warp_sums[kScanThreads / 32];
    __shared__ long long tile_s, excl_s[gsdf::kSums];
    if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = tile_s;
    const long long w = tile * kScanThreads + threadIdx.x;
    uint32_t live = 0u;
    unsigned long long packed = 0;  // the word's counts, a field each
    if (w < s.words) {
        live = gsdf_dcw::live_word(ebits, s, w, gsdf_dcw::word_masks(s, w));
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const int n = __popc(__ldg(ebits + a * s.words + w));
            packed |= (unsigned long long)n << (kField * a);
        }
        packed |= (unsigned long long)__popc(live) << (3 * kField);
    }
    unsigned long long total;
    const unsigned long long p =
        gsdf::block_exclusive_scan<kScanThreads>(packed, &total, warp_sums);
    if (threadIdx.x < 32) {  // the tile's prefix across tiles (decoupled look-back)
        long long agg[gsdf::kSums] = {
            (long long)((total & kFieldMask) | ((total >> kField) & kFieldMask) << kPair),
            (long long)((total >> (2 * kField)) & kFieldMask), (long long)(total >> (3 * kField))};
        long long excl[gsdf::kSums] = {0, 0, 0};
        if (tile == 0) {
            if (threadIdx.x == 0) gsdf::publish(status, tiles, 0, gsdf::kPrefix, agg);
        } else {
            if (threadIdx.x == 0) gsdf::publish(status, tiles, tile, gsdf::kAggregate, agg);
            gsdf::look_back(status, tiles, tile, excl);
        }
        if (threadIdx.x == 0) {
#pragma unroll
            for (int k = 0; k < gsdf::kSums; ++k) {
                excl_s[k] = excl[k];
                agg[k] += excl[k];
            }
            if (tile != 0) gsdf::publish(status, tiles, tile, gsdf::kPrefix, agg);
            if (tile == tiles - 1) {
                counts[0] = agg[0] & kPairMask;
                counts[1] = agg[0] >> kPair;
                counts[2] = agg[1];
                counts[3] = agg[2];
            }
        }
    }
    __syncthreads();
    if (w >= s.words) return;
    edir[w] = (int32_t)((excl_s[0] & kPairMask) + (long long)(p & kFieldMask));
    edir[s.words + w] = (int32_t)((excl_s[0] >> kPair) + (long long)((p >> kField) & kFieldMask));
    edir[2 * s.words + w] = (int32_t)(excl_s[1] + (long long)((p >> (2 * kField)) & kFieldMask));
    long long at = excl_s[2] + (long long)(p >> (3 * kField));
    for (; live != 0u; live &= live - 1u) uvox[at++] = (int32_t)(32 * w + __ffs(live) - 1);
}

__device__ __forceinline__ bool edge_bit(const uint32_t* __restrict__ ebits, const Space& s,
                                         int axis, long long v) {
    return (__ldg(ebits + axis * s.words + (v >> 5)) >> (v & 31)) & 1u;
}

// The slot of voxel v's active edge of `axis` in the ascending edge list.
__device__ __forceinline__ long long edge_slot(const uint32_t* __restrict__ ebits,
                                               const int32_t* __restrict__ edir,
                                               const long long* __restrict__ counts,
                                               const Space& s, int axis, long long v) {
    const long long w = axis * s.words + (v >> 5);
    const long long base = axis == 0 ? 0 : axis == 1 ? counts[0] : counts[0] + counts[1];
    const uint32_t below = (1u << (v & 31)) - 1u;
    return base + __ldg(edir + w) + __popc(__ldg(ebits + w) & below);
}

// (d) every active edge at its slot: id, t, flip, crossing point. A warp
// takes 32 consecutive words, a lane one; the voxels with an active edge
// (a warp scan of each word's count) are listed in shared memory in
// order, and the warp writes their edges 32 voxels at a time, a word's
// ballot bits and ranks shuffled from the lane that loaded them.
__global__ void __launch_bounds__(kEdgeThreads)
edges_kernel(const float* __restrict__ dist, Space s, const uint32_t* __restrict__ ebits,
             const int32_t* __restrict__ edir, const long long* __restrict__ counts, float ox,
             float oy, float oz, float res, int k0, int32_t* __restrict__ eids,
             uint8_t* __restrict__ flips, float* __restrict__ tvals, float* __restrict__ pts) {
    __shared__ uint16_t listed[kEdgeThreads / 32][32 * 32];  // (word lane << 5) | bit
    const int lane = threadIdx.x & 31;
    const long long first = (long long)blockIdx.x * kEdgeThreads + threadIdx.x - lane;
    uint32_t mine[3] = {0u, 0u, 0u};
    int32_t rank[3] = {0, 0, 0};
    if (first + lane < s.words) {
#pragma unroll
        for (int a = 0; a < 3; ++a) mine[a] = __ldg(ebits + a * s.words + first + lane);
    }
    const uint32_t any = mine[0] | mine[1] | mine[2];
    const int n = __popc(any);
    int upto = n;  // inclusive warp scan of the words' active voxels
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, upto, o);
        if (lane >= o) upto += y;
    }
    const int total = __shfl_sync(0xffffffffu, upto, 31);
    if (total == 0) return;
    if (any != 0u) {
#pragma unroll
        for (int a = 0; a < 3; ++a) rank[a] = __ldg(edir + a * s.words + first + lane);
    }
    uint16_t* list = listed[threadIdx.x >> 5];
    int at = upto - n;
    for (uint32_t bits = any; bits != 0u; bits &= bits - 1u)
        list[at++] = (uint16_t)((lane << 5) | (__ffs(bits) - 1));
    __syncwarp();
    const long long base[3] = {0, counts[0], counts[0] + counts[1]};
    const long long ni = s.nx + 1, cplane = ni * (s.ny + 1);
    const long long step[3] = {1, ni, cplane};
    for (int start = 0; start < total; start += 32) {
        const int item = start + lane < total ? list[start + lane] : 0;
        const int src = item >> 5, b = item & 31;
        uint32_t words[3];
        int32_t ranks[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            words[a] = __shfl_sync(0xffffffffu, mine[a], src);
            ranks[a] = __shfl_sync(0xffffffffu, rank[a], src);
        }
        if (start + lane >= total) continue;
        const uint32_t bit = 1u << b;
        const long long v = 32 * (first + src) + b;
        const Voxel x = voxel_of(v, s);
        const float* c0 = dist + x.k * cplane + x.j * ni + x.i;
        const float d0 = c0[0];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            if ((words[a] & bit) == 0u) continue;
            const long long slot = base[a] + ranks[a] + __popc(words[a] & (bit - 1u));
            const float de = c0[step[a]];
            const float t = gsdf_dc::edge_t(d0, de);
            eids[slot] = (int32_t)(a * s.nvox + v);
            flips[slot] = gsdf_dc::edge_flip(d0, de) ? 1 : 0;
            if (tvals != nullptr) tvals[slot] = t;
            float p[3];
            gsdf_dc::corner_position(ox, oy, oz, res, x.i, x.j, k0 + x.k, p);
            p[a] = p[a] + t * res;
            pts[3 * slot] = p[0];
            pts[3 * slot + 1] = p[1];
            pts[3 * slot + 2] = p[2];
        }
    }
}

// (e) central-difference normals at the crossing points, a thread per
// evaluation: thread 6 e + 2 d + h evaluates edge e's point + half (h = 0)
// or - half (h = 1) on axis d, and the + lane writes (+ - -) * scale. The
// two lanes of a pair always share a warp (6 e + 2 d is even).
__global__ void __launch_bounds__(kNormalThreads)
normals_kernel(const float* __restrict__ pts, int n_edges, float half, float scale,
               float* __restrict__ nrm GSDF_PARAMS_DECL) {
    const long long t = (long long)blockIdx.x * kNormalThreads + threadIdx.x;
    const bool in = t < 6LL * n_edges;
    const long long e = t / 6;
    const int d = (int)(t - 6 * e) >> 1, minus = (int)(t & 1);
    float f = 0.0f;
    if (in) {
        float q[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float h = c == d ? half : 0.0f;
            const float p = __ldg(pts + 3 * e + c);
            q[c] = minus ? p - h : p + h;
        }
        f = GSDF_TREE(q[0], q[1], q[2]);
    }
    const float lo = __shfl_xor_sync(0xffffffffu, f, 1);
    if (in && !minus) nrm[3 * e + d] = (f - lo) * scale;
}

// (f) each live voxel's rows, sums, solve and vertex. The gathers' loads
// go out in rounds, not one row after another: all 15 rows' ballot words,
// then the active rows' ranks, then three rows' normals and points at a
// time (more rows a round cost registers and resident blocks); the rows
// are added in the static order, the float operations unchanged.
__global__ void __launch_bounds__(kQefThreads)
qef_kernel(const int32_t* __restrict__ uvox, int n_vox, Space s,
           const uint32_t* __restrict__ ebits, const int32_t* __restrict__ edir,
           const long long* __restrict__ counts, const float* __restrict__ pts,
           const float* __restrict__ nrm, float ox, float oy, float oz, float res, int k0,
           float l2, float* __restrict__ verts) {
    const int t = blockIdx.x * kQefThreads + threadIdx.x;
    if (t >= n_vox) return;
    const long long v = __ldg(uvox + t);
    const int i = (int)(v % s.nx);
    const int j = (int)((v / s.nx) % s.ny);
    const int k = (int)(v / s.plane);
    const float o[3] = {ox, oy, oz};
    const float idx[3] = {(float)i, (float)j, (float)(k + k0)};
    const long long base[3] = {0, counts[0], counts[0] + counts[1]};
    int ev[15];
    uint32_t word[15];
#pragma unroll
    for (int c = 0; c < 15; ++c) {
        const int ii = i + kDcGather[c][1], jj = j + kDcGather[c][2], kk = k + kDcGather[c][3];
        const bool in = ii < s.nx && jj < s.ny && kk < s.layers;
        ev[c] = in ? (kk * s.ny + jj) * s.nx + ii : -1;
        word[c] = in ? __ldg(ebits + kDcGather[c][0] * s.words + (ev[c] >> 5)) : 0u;
    }
    long long slot[15];
#pragma unroll
    for (int c = 0; c < 15; ++c) {
        const uint32_t bit = ev[c] < 0 ? 0u : 1u << (ev[c] & 31);
        const int a = kDcGather[c][0];
        slot[c] = (word[c] & bit) ? base[a] + __ldg(edir + a * s.words + (ev[c] >> 5)) +
                                        __popc(word[c] & (bit - 1u))
                                  : -1;
    }
    float sums[gsdf_dc::kSums];
#pragma unroll
    for (int c = 0; c < gsdf_dc::kSums; ++c) sums[c] = 0.0f;
#pragma unroll
    for (int g = 0; g < 15; g += 3) {
        float n[3][3], p[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                n[r][d] = slot[g + r] >= 0 ? __ldg(nrm + 3 * slot[g + r] + d) : 0.0f;
                p[r][d] = slot[g + r] >= 0 ? __ldg(pts + 3 * slot[g + r] + d) : 0.0f;
            }
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            if (slot[g + r] < 0) continue;
            float q[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) q[d] = (p[r][d] - o[d]) / res - idx[d];
            gsdf_dc::qef_add(sums, n[r], q);
        }
    }
    float x[3];
    gsdf_dc::qef_solve(sums, l2, x);
#pragma unroll
    for (int d = 0; d < 3; ++d) verts[3 * t + d] = (o[d] + idx[d] * res) + x[d] * res;
}

bool shape_ok(int nk, int nj, int ni, int n_own) {
    if (nk < 2 || nj < 2 || ni < 2 || n_own < 1 || n_own > nk - 1 || nk > 65535) return false;
    const long long plane = (long long)nj * ni;
    const long long nvox = (long long)(nk - 1) * (nj - 1) * (ni - 1);
    return plane <= 0x7fffffffLL && 3 * nvox < (1LL << 31);
}

long long tiles_of(long long words) { return (words + kScanThreads - 1) / kScanThreads; }

}  // namespace

// The int64 work buffer of an (nk, nj, ni) grid with n_own owned layers:
// counts (4: x, y, z edges, live voxels), the scan's status words (3 per
// tile) and one word for its ticket. -1 for a shape the kernels do not
// take.
extern "C" long long gsdf_dc_work(int nk, int nj, int ni, int n_own) {
    if (!shape_ok(nk, nj, ni, n_own)) return -1;
    return 4 + gsdf::kSums * tiles_of(gsdf_dcw::make_space(nk, nj, ni, n_own).words) + 1;
}

// (a), (b), (c) on `stream`: dist (nk, nj, ni), work (gsdf_dc_work
// words), ebits and edir (3 * ceil(nvox / 32) each), uvox (one int32 per
// owned voxel). Returns cudaGetLastError() (0 = launched). The parametric
// entry point also takes the parameter vector and its length
// (classified_grid.cu says how).
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_dc_count_param(float* dist, float ox, float oy, float oz, float res, int k0,
                                   int nk, int nj, int ni, int n_own, long long* work,
                                   uint32_t* ebits, int32_t* edir, int32_t* uvox,
                                   const float* params, int n_params, void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_dc_count(float* dist, float ox, float oy, float oz, float res, int k0, int nk,
                             int nj, int ni, int n_own, long long* work, uint32_t* ebits,
                             int32_t* edir, int32_t* uvox, void* stream) {
#endif
    if (!shape_ok(nk, nj, ni, n_own)) return (int)cudaErrorInvalidValue;
    const Space sp = gsdf_dcw::make_space(nk, nj, ni, n_own);
    const long long tiles = tiles_of(sp.words), n_work = gsdf_dc_work(nk, nj, ni, n_own);
    const long long plane = (long long)nj * ni;
    if (n_work > nk * plane) return (int)cudaErrorInvalidValue;  // the eval pass zeroes it
    long long* counts = work;
    unsigned long long* status = reinterpret_cast<unsigned long long*>(work + 4);
    unsigned* ticket = reinterpret_cast<unsigned*>(status + gsdf::kSums * tiles);
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 eval_grid((unsigned)((plane + kEvalThreads - 1) / kEvalThreads), (unsigned)nk);
    eval_kernel<<<eval_grid, kEvalThreads, 0, s>>>(dist, ox, oy, oz, res, k0, nj, ni, work,
                                                   n_work GSDF_PARAMS_ARG);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    constexpr long long flag_block_words = kFlagThreads / 32 * kFlagWords;
    flags_kernel<<<(unsigned)((sp.words + flag_block_words - 1) / flag_block_words), kFlagThreads,
                   0, s>>>(dist, sp, ebits);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    scan_kernel<<<(unsigned)tiles, kScanThreads, 0, s>>>(ebits, sp, tiles, status, ticket, edir,
                                                         uvox, counts);
    return (int)cudaGetLastError();
}

// (d), (e) and, where verts is not null, (f) on `stream`, at the counts
// the wrapper read from work: eids (int32), flips (u8), tvals (f32, or
// null), pts and nrm (3 f32 each) per edge, verts (3 f32 per live voxel).
// half is half the normal step, scale multiplies the normals' differences,
// l2 is the squared regularisation row weight.
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_dc_emit_param(const float* dist, float ox, float oy, float oz, float res,
                                  int k0, int nk, int nj, int ni, int n_own,
                                  const long long* work, const uint32_t* ebits,
                                  const int32_t* edir, const int32_t* uvox, int n_edges,
                                  int n_vox, float half, float scale, float l2, int32_t* eids,
                                  uint8_t* flips, float* tvals, float* pts, float* nrm,
                                  float* verts, const float* params, int n_params,
                                  void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_dc_emit(const float* dist, float ox, float oy, float oz, float res, int k0,
                            int nk, int nj, int ni, int n_own, const long long* work,
                            const uint32_t* ebits, const int32_t* edir, const int32_t* uvox,
                            int n_edges, int n_vox, float half, float scale, float l2,
                            int32_t* eids, uint8_t* flips, float* tvals, float* pts, float* nrm,
                            float* verts, void* stream) {
#endif
    if (!shape_ok(nk, nj, ni, n_own) || n_edges < 0 || n_vox < 0) return (int)cudaErrorInvalidValue;
    if (n_edges == 0) return 0;
    const Space sp = gsdf_dcw::make_space(nk, nj, ni, n_own);
    const cudaStream_t s = (cudaStream_t)stream;
    edges_kernel<<<(unsigned)((sp.words + kEdgeThreads - 1) / kEdgeThreads), kEdgeThreads, 0, s>>>(
        dist, sp, ebits, edir, work, ox, oy, oz, res, k0, eids, flips, tvals, pts);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    normals_kernel<<<(unsigned)((6LL * n_edges + kNormalThreads - 1) / kNormalThreads),
                     kNormalThreads, 0, s>>>(pts, n_edges, half, scale, nrm GSDF_PARAMS_ARG);
    rc = (int)cudaGetLastError();
    if (rc != 0 || verts == nullptr || n_vox == 0) return rc;
    qef_kernel<<<(unsigned)((n_vox + kQefThreads - 1) / kQefThreads), kQefThreads, 0, s>>>(
        uvox, n_vox, sp, ebits, edir, work, pts, nrm, ox, oy, oz, res, k0, l2, verts);
    return (int)cudaGetLastError();
}
