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
//     each corner's edge goes to its owner cube, and the owner to its
//     first vertex plus the rank of the axis among its crossing edges;
//   - the count of triangle corners whose owner is outside the grid,
//     inactive, or has no vertex on that edge. Those corners get index -1;
//     the renderer then welds the soup instead (render/flat.py). The JAX
//     package clamps such owners and binds a wrong vertex there.
//
// What bounds it on the card: 12 B written per vertex and per triangle and
// the owner lookups; the work is O(active cubes), so at the main path's
// sizes launches, host reads and scratch cost more than the bytes. The
// design is one launch, no read and no map of the grid:
//   - K3 (compact_active.cu) already counted vertices (a welded vertex is
//     a crossing owner edge of an active cube) and triangles, and wrote
//     both sums before every 256th active cube, so the wrapper allocates
//     exactly and a block of 256 cubes starts at its offsets; one 32-bit
//     block scan places a cube's vertices and triangles;
//   - an owner's first vertex comes from K3's edge_ranks directory (the
//     crossing edges before every 32nd cube of the grid, 4 B per 32 cubes)
//     and the crossing edges of the case bytes between the owner and the
//     nearer end of its chunk (gsdf_scan.cuh::owner_edges_before): no
//     cube -> slot map of 4 B per cube, no memset of it, and no pass that
//     fills it. Nothing is written
//     for a cube that is not active, so no padding can clobber a slot (the
//     trap of the reference's commit 122c151). Vertices and triangles no
//     longer depend on each other's launches;
//   - each thread resolves its cube's crossing edges once, owner by
//     owner with the loads of all owners in flight together (12 slots in
//     shared memory), then walks the table;
//   - vertices and index triples are staged in shared memory and written
//     by the whole block as consecutive 16-byte words (store_staged).
// Built with -fmad=false and IEEE division: bit-identical to the plain
// torch version.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_mc_tables.cuh"
#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 256;  // active cubes per block: the stride of K3's offsets
constexpr int kVertWords = kThreads * 3 * 3;  // 3 owner edges a cube at most
constexpr int kTriWords = kThreads * 5 * 3;   // 5 triangles a cube at most

__global__ void __launch_bounds__(kThreads)
welded_kernel(const float* __restrict__ grid, const uint8_t* __restrict__ cases,
              const int32_t* __restrict__ ids, long long A, int nx, int ny, int nz,
              float ox, float oy, float oz, float res, float k0f,
              const long long* __restrict__ vert_offsets,
              const long long* __restrict__ tri_offsets,
              const int32_t* __restrict__ edge_ranks, float* __restrict__ verts,
              int32_t* __restrict__ tri_idx, int* __restrict__ unresolved) {
    __shared__ __align__(16) float vstage[kVertWords + 4];
    __shared__ __align__(16) int32_t tstage[kTriWords + 4];
    __shared__ int32_t edge_vert[12][kThreads];  // a column per thread
    __shared__ unsigned warp_sums[kThreads / 32];
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long id = a < A ? __ldg(ids + a) : 0;
    const unsigned c = a < A ? __ldg(cases + id) : 0u;
    const unsigned cross = gsdf::cross_bits(c);
    const int nt = kTriCount[c];
    // one scan of both counts: at most 768 vertices and 1,280 triangles a block
    unsigned totals;
    const unsigned before = gsdf::block_exclusive_scan<kThreads>(
        (unsigned)nt << 16 | (unsigned)__popc(cross), &totals, warp_sums);
    const int vfirst = before & 0xffffu, tfirst = before >> 16;
    const long long v0 = __ldg(vert_offsets + blockIdx.x);
    float* vdst = verts + v0 * 3;
    int32_t* tdst = tri_idx + __ldg(tri_offsets + blockIdx.x) * 3;
    const int vshift = gsdf::stage_shift(vdst), tshift = gsdf::stage_shift(tdst);

    if (a < A) {
        const gsdf::Cube q = gsdf::cube_of(id, nx, ny);
        if (cross) {  // the vertices on this cube's own crossing edges
            const long long ni = nx + 1, nj = ny + 1;
            const long long base = ((long long)q.k * nj + q.j) * ni + q.i;
            const float d0 = __ldg(grid + base);
            const long long step[3] = {1, ni, nj * ni};  // far corners 1, 3, 4
            const float b[3] = {ox + (float)q.i * res, oy + (float)q.j * res,
                                oz + ((float)q.k + k0f) * res};
            float* p = vstage + vshift + vfirst * 3;
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
                if (!(cross >> ax & 1u)) continue;
                const gsdf::EdgeT et = gsdf::mc_edge_t(d0, __ldg(grid + base + step[ax]));
#pragma unroll
                for (int x = 0; x < 3; ++x)  // corner 0 to the far corner on axis ax
                    p[x] = gsdf::mc_lerp(et, b[x] + 0.0f * res,
                                         b[x] + (x == ax ? 1.0f : 0.0f) * res);
                p += 3;
            }
        }
        // The vertex on each crossing edge of the cube, through the edge's
        // owner, owner by owner (kOwnerEdge: the cube itself and six
        // neighbours). The loads of all six lookups are started first, and
        // their addresses depend on the cube id alone, so they are in
        // flight together: one round trip to L2, where a lookup after
        // another cost a block some twelve.
        const long long ncubes = (long long)nx * ny * nz;
        unsigned want[7];  // the axes of an owner's edges that cross in this cube
        long long oid[7];  // the owner's id; the cube's own where there is none to ask
        gsdf::OwnerLoad load[7];
#pragma unroll
        for (int o = 1; o < 7; ++o) {
            const int di = o & 1, dj = o >> 1 & 1, dk = o >> 2;
            want[o] = 0u;
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
                const int e = kOwnerEdge[3 * o + ax];
                if (e >= 0 && ((c >> kEdgePairs[2 * e]) ^ (c >> kEdgePairs[2 * e + 1])) & 1u)
                    want[o] |= 1u << ax;
            }
            if (!(q.i + di < nx && q.j + dj < ny && q.k + dk < nz)) want[o] = 0u;
            oid[o] = want[o] ? id + di + (long long)dj * nx + (long long)dk * nx * ny : id;
            load[o] = gsdf::owner_load(cases, ncubes, edge_ranks, oid[o]);
        }
#pragma unroll
        for (int o = 0; o < 7; ++o) {
            const unsigned oc = o == 0 ? c : gsdf::owner_case(load[o], oid[o]);
            const unsigned have = o == 0 ? cross : want[o] & gsdf::cross_bits(oc);
            const int first = o == 0 ? (int)(v0 + vfirst)
                                     : gsdf::owner_edges_before(load[o], oid[o]);
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
                const int e = kOwnerEdge[3 * o + ax];
                if (e < 0) continue;
                // an inactive owner (case 0) has no crossing edge
                edge_vert[e][threadIdx.x] =
                    have >> ax & 1u ? first + __popc(gsdf::cross_bits(oc) & ((1u << ax) - 1u)) : -1;
            }
        }
        int missing = 0;
        for (int s = 0; s < nt; ++s) {
            int32_t* out = tstage + tshift + (tfirst + s) * 3;
            for (int j = 0; j < 3; ++j) {
                const int32_t vid = edge_vert[kTriTable[c * 15 + s * 3 + j]][threadIdx.x];
                missing += vid < 0;
                out[2 - j] = vid;  // reversed winding
            }
        }
        if (missing) atomicAdd(unresolved, missing);
    }
    __syncthreads();
    gsdf::store_staged<kThreads>(reinterpret_cast<const uint32_t*>(vstage), vshift,
                                 reinterpret_cast<uint32_t*>(vdst), (int)(totals & 0xffffu) * 3);
    gsdf::store_staged<kThreads>(reinterpret_cast<const uint32_t*>(tstage), tshift,
                                 reinterpret_cast<uint32_t*>(tdst), (int)(totals >> 16) * 3);
}

}  // namespace

// verts (K3's edge count, 3) f32, tri_idx (K3's triangle count, 3) i32 and
// *unresolved = the corners left at -1 (cleared here, on the stream, before
// the launch). One block per 256 active cubes at K3's offsets (vertices)
// and tri_offsets; edge_ranks is K3's directory for the same case grid.
// Returns the first CUDA error, 0 if launched.
extern "C" int gsdf_emit_welded(const float* grid, const uint8_t* cases,
                                const int32_t* ids, long long A, int nx, int ny,
                                int nz, float ox, float oy, float oz, float res,
                                float k0f, const long long* vert_offsets,
                                const long long* tri_offsets, const int32_t* edge_ranks,
                                float* verts, int32_t* tri_idx, int* unresolved,
                                void* stream) {
    const long long blocks = gsdf::blocks_for(A, kThreads);
    if (A <= 0 || blocks < 0 || nx < 1 || ny < 1 || nz < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int rc = (int)cudaMemsetAsync(unresolved, 0, sizeof(int), s);
    if (rc != 0) return rc;
    welded_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        grid, cases, ids, A, nx, ny, nz, ox, oy, oz, res, k0f, vert_offsets, tri_offsets,
        edge_ranks, verts, tri_idx, unresolved);
    return (int)cudaGetLastError();
}
