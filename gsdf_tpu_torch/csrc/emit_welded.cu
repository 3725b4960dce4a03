// K7w: the welded (indexed-mesh) emit on Hopper.
//
// Replaces gsdf_tpu/ops/fused_welded.py::build_welded_render (:83-188),
// which XLA fused on the TPU. Every crossing grid edge has one owner: the
// cube whose corner 0 is the edge's low end, where it is the low edge x,
// y or z. For the active cubes (K3's ids, ascending):
//   - vertices: for each cube, its crossing owner edges in axis order x,
//     y, z (the crossing flag (v0 < 0) != (vfar < 0), which for an active
//     cube equals the case byte's sign bits), at slots from a hand-written
//     scan, so vertices are cube-major. A vertex is pa + t * (pb - pa) of
//     the owner's corner positions, with the reference's 1e-12 snaps, in
//     the JAX package's float32 arithmetic (corner_positions);
//   - triangles: MC_TRI_TABLE[case] in table order with reversed winding;
//     each corner's edge goes to its owner cube, the owner to its slot
//     (a dense cube -> slot map filled with -1, then scattered; padding
//     never writes it, the trap of the reference's commit 122c151), and
//     the slot to the vertex: the owner's first vertex plus the rank of
//     the axis among its crossing edges;
//   - the count of triangle corners whose owner is outside the grid,
//     inactive, or has no vertex on that edge. Those corners get index -1;
//     the renderer then welds the soup instead (render/flat.py). The JAX
//     package clamps such owners and binds a wrong vertex there.
//
// What bounds it on the card: the cube -> slot map (4 B per grid cube,
// set to -1 by a memset) and the scattered gathers of the owner lookups;
// the rest is O(active cubes). One thread per active cube, five launches
// after the memset: count (and slot scatter), two scans, vertices,
// triangles. Built with -fmad=false and IEEE division: bit-identical to
// the plain torch version.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_mc_tables.cuh"
#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ cases, const int32_t* __restrict__ ids,
             long long A, int32_t* __restrict__ slot_map,
             long long* __restrict__ vsums, long long* __restrict__ tsums) {
    __shared__ long long warp_sums[kThreads / 32];
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    long long nv = 0, nt = 0;
    if (a < A) {
        const int32_t id = ids[a];
        const unsigned c = cases[id];
        slot_map[id] = (int32_t)a;
        nv = gsdf::n_cross(c);
        nt = kTriCount[c];
    }
    long long total;
    gsdf::block_exclusive_scan<kThreads>(nv, &total, warp_sums);
    if (threadIdx.x == 0) vsums[blockIdx.x] = total;
    gsdf::block_exclusive_scan<kThreads>(nt, &total, warp_sums);
    if (threadIdx.x == 0) tsums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
verts_kernel(const float* __restrict__ grid, const uint8_t* __restrict__ cases,
             const int32_t* __restrict__ ids, long long A, int nx, int ny,
             float ox, float oy, float oz, float res, float k0f,
             const long long* __restrict__ voffs, int32_t* __restrict__ vbase,
             float* __restrict__ verts) {
    __shared__ long long warp_sums[kThreads / 32];
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long id = a < A ? ids[a] : 0;
    const unsigned cross = gsdf::cross_bits(a < A ? cases[id] : 0u);
    long long total;
    long long pos = voffs[blockIdx.x] +
        gsdf::block_exclusive_scan<kThreads>((long long)__popc(cross), &total, warp_sums);
    if (a >= A) return;
    vbase[a] = (int32_t)pos;
    if (!cross) return;

    const gsdf::Cube q = gsdf::cube_of(id, nx, ny);
    const long long ni = nx + 1, nj = ny + 1;
    const long long base = ((long long)q.k * nj + q.j) * ni + q.i;
    const float v0 = grid[base];
    const long long step[3] = {1, ni, nj * ni};  // far corners 1, 3, 4
    const float b[3] = {ox + (float)q.i * res, oy + (float)q.j * res,
                        oz + ((float)q.k + k0f) * res};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
        if (!(cross >> ax & 1u)) continue;
        const gsdf::EdgeT et = gsdf::mc_edge_t(v0, grid[base + step[ax]]);
        float* p = verts + pos * 3;
#pragma unroll
        for (int x = 0; x < 3; ++x)  // corner 0 to the far corner on axis ax
            p[x] = gsdf::mc_lerp(et, b[x] + 0.0f * res, b[x] + (x == ax ? 1.0f : 0.0f) * res);
        ++pos;
    }
}

__global__ void __launch_bounds__(kThreads)
tris_kernel(const uint8_t* __restrict__ cases, const int32_t* __restrict__ ids,
            long long A, int nx, int ny, int nz,
            const int32_t* __restrict__ slot_map, const long long* __restrict__ toffs,
            const int32_t* __restrict__ vbase, int32_t* __restrict__ tri_idx,
            int* __restrict__ unresolved) {
    __shared__ long long warp_sums[kThreads / 32];
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long id = a < A ? ids[a] : 0;
    const unsigned c = a < A ? cases[id] : 0u;
    const int nt = kTriCount[c];
    long long total;
    const long long t0 = toffs[blockIdx.x] +
        gsdf::block_exclusive_scan<kThreads>((long long)nt, &total, warp_sums);
    if (a >= A || nt == 0) return;

    const gsdf::Cube q = gsdf::cube_of(id, nx, ny);
    int missing = 0;
    for (int s = 0; s < nt; ++s) {
        int32_t* out = tri_idx + (t0 + s) * 3;
        for (int j = 0; j < 3; ++j) {
            const int e = kTriTable[c * 15 + s * 3 + j];
            const int oi = q.i + kEdgeLow[3 * e];
            const int oj = q.j + kEdgeLow[3 * e + 1];
            const int ok = q.k + kEdgeLow[3 * e + 2];
            int32_t vid = -1;
            if (oi < nx && oj < ny && ok < nz) {
                const long long olin = ((long long)ok * ny + oj) * nx + oi;
                const int32_t slot = slot_map[olin];
                const unsigned ocross = gsdf::cross_bits(cases[olin]);
                const int ax = kEdgeAxis[e];
                if (slot >= 0 && (ocross >> ax & 1u))
                    vid = vbase[slot] + __popc(ocross & ((1u << ax) - 1u));
            }
            missing += vid < 0;
            out[2 - j] = vid;  // reversed winding
        }
    }
    if (missing) atomicAdd(unresolved, missing);
}

}  // namespace

// int64 scratch entries per count (block sums) for A active cubes; the
// wrapper allocates two such arrays back to back. -1 if too many.
extern "C" long long gsdf_emit_welded_blocks(long long A) {
    return gsdf::blocks_for(A, kThreads);
}

// Memset of the slot map, then launches 1 and 2: block_sums[0, B) become
// the vertex block offsets and block_sums[B, 2B) the triangle ones;
// totals[0] = vertices, totals[1] = triangles. slot_map holds ncubes
// int32. Returns the first CUDA error, 0 if all launched.
extern "C" int gsdf_emit_welded_count(const uint8_t* cases, const int32_t* ids,
                                      long long A, long long ncubes,
                                      int32_t* slot_map, long long* block_sums,
                                      long long* totals, void* stream) {
    const long long blocks = gsdf::blocks_for(A, kThreads);
    if (A <= 0 || blocks < 0 || ncubes < A) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    int rc = (int)cudaMemsetAsync(slot_map, 0xff, (size_t)ncubes * sizeof(int32_t), s);
    if (rc != 0) return rc;
    count_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(cases, ids, A, slot_map,
                                                       block_sums, block_sums + blocks);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    rc = gsdf::scan_sums(block_sums, blocks, totals, s);
    if (rc != 0) return rc;
    return gsdf::scan_sums(block_sums + blocks, blocks, totals + 1, s);
}

// Launches 3 and 4: verts (totals[0], 3) f32, tri_idx (totals[1], 3) i32,
// vbase (A) scratch, *unresolved += corners left at -1 (zeroed by the
// caller).
extern "C" int gsdf_emit_welded(const float* grid, const uint8_t* cases,
                                const int32_t* ids, long long A, int nx, int ny,
                                int nz, float ox, float oy, float oz, float res,
                                float k0f, const int32_t* slot_map,
                                const long long* block_offsets, int32_t* vbase,
                                float* verts, int32_t* tri_idx, int* unresolved,
                                void* stream) {
    const long long blocks = gsdf::blocks_for(A, kThreads);
    if (A <= 0 || blocks < 0 || nx < 1 || ny < 1 || nz < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    verts_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        grid, cases, ids, A, nx, ny, ox, oy, oz, res, k0f, block_offsets, vbase, verts);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    tris_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        cases, ids, A, nx, ny, nz, slot_map, block_offsets + blocks, vbase, tri_idx,
        unresolved);
    return (int)cudaGetLastError();
}
