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
//     origin + (float)(global index) * res: K2's values bit for bit;
//     (b) flags: each voxel of the edge space tests its three edges (sign
//     bits of the ends), a warp's ballot per axis is stored (4 B per 32
//     voxels and axis) and, by a single-pass scan with decoupled
//     look-back (gsdf_scan.cuh), each ballot word's rank among its axis's
//     active edges (another 4 B); the last tile writes the three axis
//     totals. A tile is 8,192 voxels, 8 consecutive words per warp: a
//     lane's loads for its 8 voxels are in flight together and the block
//     scans once (PERF.md: tiles of 1,024 voxels, and then 8 block-wide
//     rounds of them, left these passes latency-bound);
//     (c) live: each owned voxel ORs the ballot bits of its 15 edges; the
//     same scan writes the ascending live voxel ids (ids buffer of one
//     int32 per owned voxel) and their count.
//   gsdf_dc_emit, at the exact counts:
//     (d) edges: one thread per voxel writes each active edge at its rank
//     (axis base + word rank + bits below): id axis*nvox + voxel, t, flip
//     and the crossing point (a warp whose words are 0 returns at once);
//     (e) normals: one thread per edge, 6 tree evaluations at the point
//     +- half a step on each axis, differences times `scale`;
//     (f) qef: one thread per live voxel gathers its rows in the static
//     order (an edge's slot from its ballot word and rank), sums the 13
//     columns, solves (gsdf_qef.cuh) and places the vertex.
//
// What bounds it on the card: the ALU, on the tree at every corner and 6
// times at every active edge (gsdf_tpu_torch/bounds.py); the bytes, 4 per
// corner written and read back, are far below. The QEF's 5 Jacobi sweeps
// (45 precise transcendentals a voxel) are a few percent of it.
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
#include "gsdf_dc_tables.cuh"

namespace {

constexpr int kEvalThreads = 256;
constexpr int kThreads = 1024;  // the two scans
constexpr int kWords = 8;       // consecutive 32-voxel words per warp: few, short tiles
constexpr long long kTile = (long long)kThreads * kWords;
constexpr int kFieldShift = 21;  // three per-tile counts (<= kTile) in one word
static_assert(kTile < (1LL << kFieldShift), "a tile's counts fit their fields");
constexpr long long kFieldMask = (1LL << kFieldShift) - 1;
constexpr int kEmitThreads = 256;
constexpr int kNormalThreads = 128;
constexpr int kQefThreads = 128;

struct Grid {
    int nx, ny, layers, n_own;  // voxels per row, rows, edge layers, owned layers
    long long plane, nvox;      // voxels per layer, voxels of the edge space
    long long chunks;           // 32-voxel words per axis
};

__host__ __device__ inline Grid make_grid(int nk, int nj, int ni, int n_own) {
    Grid g;
    g.nx = ni - 1;
    g.ny = nj - 1;
    g.layers = nk - 1;
    g.n_own = n_own;
    g.plane = (long long)g.nx * g.ny;
    g.nvox = g.plane * g.layers;
    g.chunks = (g.nvox + 31) / 32;
    return g;
}

__global__ void __launch_bounds__(kEvalThreads)
eval_kernel(float* __restrict__ dist, float ox, float oy, float oz, float res, int k0, int nj,
            int ni GSDF_PARAMS_DECL) {
    const unsigned plane = (unsigned)nj * (unsigned)ni;
    const unsigned c = blockIdx.x * kEvalThreads + threadIdx.x;
    if (c >= plane) return;
    const int j = (int)(c / (unsigned)ni);
    const int i = (int)(c - (unsigned)j * (unsigned)ni);
    const int k = (int)blockIdx.y;
    float p[3];
    gsdf_dc::corner_position(ox, oy, oz, res, i, j, k0 + k, p);
    dist[(long long)k * plane + c] = GSDF_TREE(p[0], p[1], p[2]);
}

// Exclusive prefix of three counts over the block's warps: each warp's
// lane 0 offers its packed counts. Returns the warp's prefix (on every
// lane) and the block's total in *total.
__device__ __forceinline__ long long warp_prefix(long long packed, long long* total,
                                                 long long* warp_sums) {
    const long long pre = gsdf::block_exclusive_scan<kThreads>(
        (threadIdx.x & 31) == 0 ? packed : 0LL, total, warp_sums);
    return __shfl_sync(0xffffffffu, pre, 0);
}

__device__ __forceinline__ void unpack(long long packed, long long* v) {
    v[0] = packed & kFieldMask;
    v[1] = (packed >> kFieldShift) & kFieldMask;
    v[2] = packed >> (2 * kFieldShift);
}

// The tile's exclusive prefixes across tiles (decoupled look-back), by the
// first warp; returned through shared memory to every thread.
__device__ __forceinline__ void tile_prefix(unsigned long long* status, long long tiles,
                                            long long tile, long long total, long long* excl_s,
                                            long long* counts) {
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
                agg[s] += excl[s];
            }
            if (tile != 0) gsdf::publish(status, tiles, tile, gsdf::kPrefix, agg);
            if (tile == tiles - 1)
                for (int s = 0; s < gsdf::kSums; ++s) counts[s] = agg[s];
        }
    }
    __syncthreads();
}

__device__ __forceinline__ bool edge_bit(const uint32_t* __restrict__ ebits, const Grid& g,
                                         int axis, long long v) {
    return (__ldg(ebits + axis * g.chunks + (v >> 5)) >> (v & 31)) & 1u;
}

// The slot of voxel v's active edge of `axis` in the ascending edge list.
__device__ __forceinline__ long long edge_slot(const uint32_t* __restrict__ ebits,
                                               const int32_t* __restrict__ edir,
                                               const long long* __restrict__ counts,
                                               const Grid& g, int axis, long long v) {
    const long long w = axis * g.chunks + (v >> 5);
    const long long base = axis == 0 ? 0 : axis == 1 ? counts[0] : counts[0] + counts[1];
    const uint32_t below = (1u << (v & 31)) - 1u;
    return base + __ldg(edir + w) + __popc(__ldg(ebits + w) & below);
}

// A voxel's (i, j, k) from its id, v < 2^31 (shape_ok): 32-bit division.
struct Voxel {
    int i, j, k;
};
__device__ __forceinline__ Voxel voxel_of(long long v, const Grid& g) {
    const unsigned u = (unsigned)v, row = u / (unsigned)g.nx;
    Voxel x;
    x.i = (int)(u - row * (unsigned)g.nx);
    x.j = (int)(row % (unsigned)g.ny);
    x.k = (int)(row / (unsigned)g.ny);
    return x;
}

// (b) the edge flags: ballot words, their ranks and the three axis totals.
// Each warp takes kWords consecutive 32-voxel words of the tile, a lane
// one voxel of each, so that a lane's loads for all its words are in
// flight together and a word's rank in its warp is a running sum; one
// block scan gives the warps' offsets in the tile and the look-back the
// tile's.
__global__ void __launch_bounds__(kThreads)
flags_kernel(const float* __restrict__ dist, Grid g, long long tiles,
             unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
             uint32_t* __restrict__ ebits, int32_t* __restrict__ edir,
             long long* __restrict__ counts) {
    __shared__ long long warp_sums[kThreads / 32];
    __shared__ long long tile_s, excl_s[gsdf::kSums];
    if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = tile_s;
    const int lane = threadIdx.x & 31;
    const long long word0 = (tile * kTile + (long long)(threadIdx.x >> 5) * 32 * kWords) >> 5;
    const long long ni = g.nx + 1, cplane = ni * (g.ny + 1);
    long long run = 0;        // packed counts of the warp's earlier words
    long long rank[kWords];   // each word's packed rank in its warp
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
        const long long v = (word0 + r) * 32 + lane;
        bool act[3] = {false, false, false};
        if (v < g.nvox) {
            const Voxel x = voxel_of(v, g);
            const float* c0 = dist + x.k * cplane + x.j * ni + x.i;
            const float d0 = c0[0];
            act[0] = gsdf_dc::edge_active(d0, c0[1]);
            act[1] = gsdf_dc::edge_active(d0, c0[ni]);
            act[2] = gsdf_dc::edge_active(d0, c0[cplane]);
        }
        long long packed = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const uint32_t word = __ballot_sync(0xffffffffu, act[a]);
            packed |= (long long)__popc(word) << (kFieldShift * a);
            if (lane == 0 && word0 + r < g.chunks) ebits[a * g.chunks + word0 + r] = word;
        }
        rank[r] = run;
        run += packed;  // fields stay below 2^21: a tile holds kTile voxels
    }
    long long total;
    const long long pre = warp_prefix(run, &total, warp_sums);
    tile_prefix(status, tiles, tile, total, excl_s, counts);
    if (lane != 0) return;
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
        if (word0 + r >= g.chunks) break;
        long long p[3];
        unpack(pre + rank[r], p);
#pragma unroll
        for (int a = 0; a < 3; ++a) edir[a * g.chunks + word0 + r] = (int32_t)(excl_s[a] + p[a]);
    }
}

// (c) live voxels: ascending ids of the owned voxels with an active edge
// among their 15, and their count (counts[3]); words of a warp as in (b).
// A voxel's 15 bits are ORed without short-circuit, so that their loads
// are in flight together.
__global__ void __launch_bounds__(kThreads)
live_kernel(const uint32_t* __restrict__ ebits, Grid g, long long tiles,
            unsigned long long* __restrict__ status, unsigned* __restrict__ ticket,
            int32_t* __restrict__ uvox, long long* __restrict__ counts) {
    __shared__ long long warp_sums[kThreads / 32];
    __shared__ long long tile_s, excl_s[gsdf::kSums];
    if (threadIdx.x == 0) tile_s = atomicAdd(ticket, 1u);
    __syncthreads();
    const long long tile = tile_s;
    const int lane = threadIdx.x & 31;
    const long long v0 = tile * kTile + (long long)(threadIdx.x >> 5) * 32 * kWords + lane;
    const long long owned = g.plane * g.n_own;
    const uint32_t below = (1u << lane) - 1u;
    int run = 0;          // live voxels of the warp's earlier words
    int rank[kWords];     // this lane's voxel's rank in its warp, or -1
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
        const long long v = v0 + r * 32;
        bool live = false;
        if (v < owned) {
            const Voxel x = voxel_of(v, g);
#pragma unroll
            for (int c = 0; c < 15; ++c) {
                const int ii = x.i + kDcGather[c][1], jj = x.j + kDcGather[c][2],
                          kk = x.k + kDcGather[c][3];
                if (ii < g.nx && jj < g.ny && kk < g.layers)
                    live = live | edge_bit(ebits, g, kDcGather[c][0],
                                           ((long long)kk * g.ny + jj) * g.nx + ii);
            }
        }
        const uint32_t word = __ballot_sync(0xffffffffu, live);
        rank[r] = live ? run + __popc(word & below) : -1;
        run += __popc(word);
    }
    long long total;
    const long long pre = warp_prefix(run, &total, warp_sums);
    long long excl_v[gsdf::kSums];
    tile_prefix(status, tiles, tile, total, excl_s, excl_v);
    if (tile == tiles - 1 && threadIdx.x == 0) counts[3] = excl_s[0] + total;
#pragma unroll
    for (int r = 0; r < kWords; ++r)
        if (rank[r] >= 0) uvox[excl_s[0] + pre + rank[r]] = (int32_t)(v0 + r * 32);
}

// (d) every active edge at its slot: id, t, flip, crossing point.
__global__ void __launch_bounds__(kEmitThreads)
edges_kernel(const float* __restrict__ dist, Grid g, const uint32_t* __restrict__ ebits,
             const int32_t* __restrict__ edir, const long long* __restrict__ counts, float ox,
             float oy, float oz, float res, int k0, int32_t* __restrict__ eids,
             uint8_t* __restrict__ flips, float* __restrict__ tvals, float* __restrict__ pts) {
    const long long v = (long long)blockIdx.x * kEmitThreads + threadIdx.x;
    if (v >= g.nvox) return;
    const long long chunk = v >> 5;
    const uint32_t w0 = __ldg(ebits + chunk), w1 = __ldg(ebits + g.chunks + chunk),
                   w2 = __ldg(ebits + 2 * g.chunks + chunk);
    if ((w0 | w1 | w2) == 0u) return;
    const int i = (int)(v % g.nx);
    const int j = (int)((v / g.nx) % g.ny);
    const int k = (int)(v / g.plane);
    const long long ni = g.nx + 1, cplane = ni * (g.ny + 1);
    const float* c0 = dist + k * cplane + j * ni + i;
    const float d0 = c0[0];
    const uint32_t bit = 1u << (v & 31);
    const uint32_t words[3] = {w0, w1, w2};
    const long long step[3] = {1, ni, cplane};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        if (!(words[a] & bit)) continue;
        const long long s = edge_slot(ebits, edir, counts, g, a, v);
        const float de = c0[step[a]];
        const float t = gsdf_dc::edge_t(d0, de);
        eids[s] = (int32_t)(a * g.nvox + v);
        flips[s] = gsdf_dc::edge_flip(d0, de) ? 1 : 0;
        if (tvals != nullptr) tvals[s] = t;
        float p[3];
        gsdf_dc::corner_position(ox, oy, oz, res, i, j, k0 + k, p);
        p[a] = p[a] + t * res;
        pts[3 * s] = p[0];
        pts[3 * s + 1] = p[1];
        pts[3 * s + 2] = p[2];
    }
}

// (e) central-difference normals at the crossing points.
__global__ void __launch_bounds__(kNormalThreads)
normals_kernel(const float* __restrict__ pts, int n_edges, float half, float scale,
               float* __restrict__ nrm GSDF_PARAMS_DECL) {
    const int s = blockIdx.x * kNormalThreads + threadIdx.x;
    if (s >= n_edges) return;
    const float p[3] = {pts[3 * s], pts[3 * s + 1], pts[3 * s + 2]};
#pragma unroll 1
    for (int d = 0; d < 3; ++d) {
        float hi[3], lo[3];
        for (int c = 0; c < 3; ++c) {
            const float e = c == d ? half : 0.0f;
            hi[c] = p[c] + e;
            lo[c] = p[c] - e;
        }
        nrm[3 * s + d] = (GSDF_TREE(hi[0], hi[1], hi[2]) - GSDF_TREE(lo[0], lo[1], lo[2])) * scale;
    }
}

// (f) each live voxel's rows, sums, solve and vertex.
__global__ void __launch_bounds__(kQefThreads)
qef_kernel(const int32_t* __restrict__ uvox, int n_vox, Grid g,
           const uint32_t* __restrict__ ebits, const int32_t* __restrict__ edir,
           const long long* __restrict__ counts, const float* __restrict__ pts,
           const float* __restrict__ nrm, float ox, float oy, float oz, float res, int k0,
           float l2, float* __restrict__ verts) {
    const int s = blockIdx.x * kQefThreads + threadIdx.x;
    if (s >= n_vox) return;
    const long long v = __ldg(uvox + s);
    const int i = (int)(v % g.nx);
    const int j = (int)((v / g.nx) % g.ny);
    const int k = (int)(v / g.plane);
    const float o[3] = {ox, oy, oz};
    const float idx[3] = {(float)i, (float)j, (float)(k + k0)};
    float sums[gsdf_dc::kSums];
#pragma unroll
    for (int c = 0; c < gsdf_dc::kSums; ++c) sums[c] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < 15; ++c) {
        const int a = kDcGather[c][0];
        const int ii = i + kDcGather[c][1], jj = j + kDcGather[c][2], kk = k + kDcGather[c][3];
        if (ii >= g.nx || jj >= g.ny || kk >= g.layers) continue;
        const long long ev = ((long long)kk * g.ny + jj) * g.nx + ii;
        if (!edge_bit(ebits, g, a, ev)) continue;
        const long long e = edge_slot(ebits, edir, counts, g, a, ev);
        float n[3], q[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            n[d] = __ldg(nrm + 3 * e + d);
            q[d] = (__ldg(pts + 3 * e + d) - o[d]) / res - idx[d];
        }
        gsdf_dc::qef_add(sums, n, q);
    }
    float x[3];
    gsdf_dc::qef_solve(sums, l2, x);
#pragma unroll
    for (int d = 0; d < 3; ++d) verts[3 * s + d] = (o[d] + idx[d] * res) + x[d] * res;
}

bool shape_ok(int nk, int nj, int ni, int n_own) {
    if (nk < 2 || nj < 2 || ni < 2 || n_own < 1 || n_own > nk - 1 || nk > 65535) return false;
    const long long plane = (long long)nj * ni;
    const long long nvox = (long long)(nk - 1) * (nj - 1) * (ni - 1);
    return plane <= 0x7fffffffLL && 3 * nvox < (1LL << 31);
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// The int64 work buffer of an (nk, nj, ni) grid with n_own owned layers:
// counts (4: x, y, z edges, live voxels), both scans' status words (3 per
// tile) and one word for their two tickets. -1 for a shape the kernels do
// not take.
extern "C" long long gsdf_dc_work(int nk, int nj, int ni, int n_own) {
    if (!shape_ok(nk, nj, ni, n_own)) return -1;
    const Grid g = make_grid(nk, nj, ni, n_own);
    return 4 + gsdf::kSums * (tiles_of(g.nvox) + tiles_of(g.plane * n_own)) + 1;
}

// (a), (b), (c) on `stream`: dist (nk, nj, ni), ebits and edir (3 * ceil(
// nvox / 32) each), uvox (one int32 per owned voxel). Returns
// cudaGetLastError() (0 = launched). The parametric entry point also takes
// the parameter vector and its length (classified_grid.cu says how).
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
    const Grid g = make_grid(nk, nj, ni, n_own);
    const long long tiles_e = tiles_of(g.nvox), tiles_v = tiles_of(g.plane * n_own);
    long long* counts = work;
    unsigned long long* status_e = reinterpret_cast<unsigned long long*>(work + 4);
    unsigned long long* status_v = status_e + gsdf::kSums * tiles_e;
    unsigned* tickets = reinterpret_cast<unsigned*>(status_v + gsdf::kSums * tiles_v);
    const cudaStream_t s = (cudaStream_t)stream;
    const long long plane = (long long)nj * ni;
    const dim3 eval_grid((unsigned)((plane + kEvalThreads - 1) / kEvalThreads), (unsigned)nk);
    eval_kernel<<<eval_grid, kEvalThreads, 0, s>>>(dist, ox, oy, oz, res, k0, nj,
                                                   ni GSDF_PARAMS_ARG);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    rc = (int)cudaMemsetAsync(work, 0, (size_t)gsdf_dc_work(nk, nj, ni, n_own) * 8, s);
    if (rc != 0) return rc;
    flags_kernel<<<(unsigned)tiles_e, kThreads, 0, s>>>(dist, g, tiles_e, status_e, tickets,
                                                        ebits, edir, counts);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    live_kernel<<<(unsigned)tiles_v, kThreads, 0, s>>>(ebits, g, tiles_v, status_v,
                                                       tickets + 1, uvox, counts);
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
    const Grid g = make_grid(nk, nj, ni, n_own);
    const cudaStream_t s = (cudaStream_t)stream;
    edges_kernel<<<(unsigned)((g.nvox + kEmitThreads - 1) / kEmitThreads), kEmitThreads, 0, s>>>(
        dist, g, ebits, edir, work, ox, oy, oz, res, k0, eids, flips, tvals, pts);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    normals_kernel<<<(unsigned)((n_edges + kNormalThreads - 1) / kNormalThreads), kNormalThreads,
                     0, s>>>(pts, n_edges, half, scale, nrm GSDF_PARAMS_ARG);
    rc = (int)cudaGetLastError();
    if (rc != 0 || verts == nullptr || n_vox == 0) return rc;
    qef_kernel<<<(unsigned)((n_vox + kQefThreads - 1) / kQefThreads), kQefThreads, 0, s>>>(
        uvox, n_vox, g, ebits, edir, work, pts, nrm, ox, oy, oz, res, k0, l2, verts);
    return (int)cudaGetLastError();
}
