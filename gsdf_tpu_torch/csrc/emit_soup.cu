// K7s: the triangle-soup emit on Hopper.
//
// Replaces gsdf_tpu/ops/mc_emit.py::emit_triangles with corner_positions
// and interpolate_edges (:305-373), which XLA fused on the TPU (the soup
// path of ops/fused_render.py and the staged ops/marching_cubes.py). For
// each active cube id (K3's output, ascending):
//   - the 8 corner distances, gathered from the f32 corner grid;
//   - the corner positions in the reference's float32 arithmetic
//     (flatrenderer.go:235-247): base = origin + f * res per axis, with
//     f = float(ci), float(cj), float(ck) + k0 (k0 is the slab's plane
//     offset, added as a float as the JAX package does), then
//     base + float(offset) * res per corner;
//   - each triangle edge's point pa + t * (pb - pa), t = (0 - va) /
//     (vb - va), with the reference's 1e-12 snaps (mcInterpolate,
//     marchcubes.go:76-98);
//   - the triangles of MC_TRI_TABLE[case] in table order with reversed
//     winding (points[t2], points[t1], points[t0]), written at the cube's
//     offset in a running sum of MC_TRI_COUNT[case], so the soup is in the
//     reference's cube-then-table order.
//
// What bounds it on the card: the 36 B written per triangle and the 8
// corner gathers per active cube; the work is O(active cubes), so at the
// main path's sizes launches and host reads cost more than the bytes. The
// design is one launch and no read: K3 (compact_active.cu) already counted
// the triangles and wrote the triangles before every 256th active cube, so
// the wrapper allocates exactly and a block of 256 cubes starts at its
// offset. One thread per active cube; a 32-bit block scan of the counts
// (at most 1,280 a block) places each cube's triangles in a shared-memory
// stage (45 KB at most), which the whole block then writes out as
// consecutive 16-byte words of its contiguous range (store_staged), so a
// warp's store covers whole lines. Corner distances come through the
// read-only path: neighbouring active cubes share them, and K1 left the
// rows in L2. Edge points are computed where a triangle needs them (the
// same arithmetic each time, so shared edges agree). Built with
// -fmad=false and IEEE division: bit-identical to the plain torch version.
//
// Tile mode (the pruned renderer's soup, gsdf_tpu/render/pruned.py::
// _tile_mc_fn :145-201): `grid` and `cases` are a tile atlas of K6a
// (tile_atlas.cu: (T*P, P, P) corners and (T*P - 1, S, S) cases, P = S + 1)
// and `tiles` its (T, 3) int32 tile table. The corners are read from the
// atlas as from any grid; only the positions change: they come from the
// cube's GLOBAL index, tile * S + local on each axis (atlas plane ka is
// tile ka / P, local k ka % P), as _tile_mc_fn makes them (:180-188). A
// template argument picks the mode, so the dense kernel is the one it was.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_mc_tables.cuh"
#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 256;  // active cubes per block: the stride of K3's tri_offsets
constexpr int kStageWords = kThreads * 5 * 9;  // 5 triangles a cube at most

template <bool kTiles>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const float* __restrict__ grid, const uint8_t* __restrict__ cases,
            const int32_t* __restrict__ ids, long long A, int nx, int ny,
            float ox, float oy, float oz, float res, float k0f,
            const int32_t* __restrict__ tiles,
            const long long* __restrict__ tri_offsets, float* __restrict__ tris) {
    __shared__ __align__(16) float stage[kStageWords + 4];
    __shared__ int warp_sums[kThreads / 32];
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long id = a < A ? __ldg(ids + a) : 0;
    const unsigned c = a < A ? __ldg(cases + id) : 0u;
    const int nt = kTriCount[c];
    int total;
    const int first = gsdf::block_exclusive_scan<kThreads>(nt, &total, warp_sums);
    float* dst = tris + __ldg(tri_offsets + blockIdx.x) * 9;
    const int shift = gsdf::stage_shift(dst);

    if (nt) {
        const gsdf::Cube q = gsdf::cube_of(id, nx, ny);
        const long long ni = nx + 1, nj = ny + 1;
        const long long base = ((long long)q.k * nj + q.j) * ni + q.i;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
            v[k] = __ldg(grid + base + kCornerOffsets[3 * k + 2] * nj * ni +
                         kCornerOffsets[3 * k + 1] * ni + kCornerOffsets[3 * k]);
        float b[3];
        if (kTiles) {  // nx == ny == S: atlas plane q.k is tile t's local plane lk
            const int t = q.k / (nx + 1), lk = q.k - t * (nx + 1);
            const int32_t* tile = tiles + 3 * t;
            b[0] = ox + (float)(__ldg(tile) * nx + q.i) * res;
            b[1] = oy + (float)(__ldg(tile + 1) * nx + q.j) * res;
            b[2] = oz + (float)(__ldg(tile + 2) * nx + lk) * res;
        } else {
            b[0] = ox + (float)q.i * res;
            b[1] = oy + (float)q.j * res;
            b[2] = oz + ((float)q.k + k0f) * res;
        }
        for (int s = 0; s < nt; ++s) {
            float* out = stage + shift + (first + s) * 9;
            for (int j = 0; j < 3; ++j) {
                const int e = kTriTable[c * 15 + s * 3 + j];
                const int ca_ = kEdgePairs[2 * e], cb_ = kEdgePairs[2 * e + 1];
                const gsdf::EdgeT et = gsdf::mc_edge_t(v[ca_], v[cb_]);
                float* p = out + (2 - j) * 3;  // reversed winding
#pragma unroll
                for (int x = 0; x < 3; ++x)
                    p[x] = gsdf::mc_lerp(et, b[x] + (float)kCornerOffsets[3 * ca_ + x] * res,
                                         b[x] + (float)kCornerOffsets[3 * cb_ + x] * res);
            }
        }
    }
    __syncthreads();
    gsdf::store_staged<kThreads>(reinterpret_cast<const uint32_t*>(stage), shift,
                                 reinterpret_cast<uint32_t*>(dst), total * 9);
}

}  // namespace

// tris (K3's triangle count, 3, 3) f32 in cube-then-table order, one block
// per 256 active cubes at K3's tri_offsets; `tiles` null for a grid, the
// atlas's tile table in tile mode (then nx == ny == S and k0f == 0).
// Returns cudaGetLastError().
extern "C" int gsdf_emit_soup(const float* grid, const uint8_t* cases,
                              const int32_t* ids, long long A, int nx, int ny,
                              float ox, float oy, float oz, float res, float k0f,
                              const int32_t* tiles, const long long* tri_offsets,
                              float* tris, void* stream) {
    const long long blocks = gsdf::blocks_for(A, kThreads);
    if (A <= 0 || blocks < 0 || nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
    if (tiles != nullptr && (nx != ny || k0f != 0.0f)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (tiles != nullptr)
        emit_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
            grid, cases, ids, A, nx, ny, ox, oy, oz, res, k0f, tiles, tri_offsets, tris);
    else
        emit_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
            grid, cases, ids, A, nx, ny, ox, oy, oz, res, k0f, tiles, tri_offsets, tris);
    return (int)cudaGetLastError();
}
