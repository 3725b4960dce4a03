// K4: the compact-field emit on Hopper.
//
// Replaces gsdf_tpu/ops/compact_field.py::compact_emit (:217-261) with
// _owner_edge_t (:60-70) and _crossing_t (:73-88), which XLA fused on the
// TPU. For each active cube id (K3's output, ascending):
//   - its case byte;
//   - v0, vx, vy, vz: the distances at corner 0 and at the far ends of
//     its three owner (low) edges, gathered from the f32 corner grid;
//   - t on each owner edge, with the reference's epsilon rules baked in
//     (mcInterpolate, marchcubes.go:76-98): 0.5 where both ends are
//     within 1e-12 of zero, else 1 or 0 where one end is, else
//     (0 - v0) / (vfar - v0);
//   - the t of the crossing edges only, compacted cube-major with axis
//     order x, y, z. The crossing counts (0-3 per cube, from the case
//     byte's sign bits) are scanned by K3 (compact_active.cu), which
//     writes each 256-cube block's offset and the total: one launch here.
// The host decoder (native mc_decode) rebuilds the mesh from ids, case
// bytes and t.
//
// What bounds it on the card: latency of the 5 gathers per active cube
// (the case byte and 4 distances, scattered over the grid); the work is
// O(active cubes), ~1-2% of the grid. One thread per active cube.
// Built with -fmad=false and IEEE division, so t is bit-identical to the
// plain torch version.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_scan.cuh"

namespace {

constexpr int kThreads = 256;

// t with the snaps baked in: 1 or 0 where one end lies within 1e-12 of zero.
__device__ __forceinline__ float owner_edge_t(float v0, float vf) {
    const gsdf::EdgeT e = gsdf::mc_edge_t(v0, vf);
    if (e.cb && !e.ca) return 1.0f;
    if (e.ca && !e.cb) return 0.0f;
    return e.t;
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(const float* __restrict__ grid, const uint8_t* __restrict__ cases,
            const int32_t* __restrict__ ids, long long A, int nx, int ny,
            const long long* __restrict__ block_offsets,
            uint8_t* __restrict__ idx8, float* __restrict__ tvals) {
    __shared__ long long warp_sums[kThreads / 32];
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long id = a < A ? ids[a] : 0;
    const unsigned c = a < A ? cases[id] : 0u;
    const unsigned cross = gsdf::cross_bits(c);
    long long total;
    long long pos = block_offsets[blockIdx.x] +
        gsdf::block_exclusive_scan<kThreads>((long long)__popc(cross), &total, warp_sums);
    if (a >= A) return;
    idx8[a] = (uint8_t)c;
    if (!cross) return;
    const gsdf::Cube q = gsdf::cube_of(id, nx, ny);
    const long long ni = nx + 1, nj = ny + 1;
    const long long base = ((long long)q.k * nj + q.j) * ni + q.i;
    const float v0 = grid[base];
    const long long step[3] = {1, ni, nj * ni};  // far corners 1, 3, 4
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
        if (cross >> ax & 1u) tvals[pos++] = owner_edge_t(v0, grid[base + step[ax]]);
}

}  // namespace

// idx8 (A) case bytes and tvals (K3's edge count) crossing-edge t, at
// the block offsets K3 wrote. Returns cudaGetLastError().
extern "C" int gsdf_compact_emit(const float* grid, const uint8_t* cases,
                                 const int32_t* ids, long long A, int nx, int ny,
                                 const long long* block_offsets, uint8_t* idx8,
                                 float* tvals, void* stream) {
    const long long blocks = gsdf::blocks_for(A, kThreads);
    if (A <= 0 || blocks < 0 || nx < 1 || ny < 1) return (int)cudaErrorInvalidValue;
    emit_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        grid, cases, ids, A, nx, ny, block_offsets, idx8, tvals);
    return (int)cudaGetLastError();
}
