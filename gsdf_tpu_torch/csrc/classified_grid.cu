// K1: fused SDF grid evaluation + marching-cubes classification on Hopper.
//
// Replaces gsdf_tpu/eval/pallas_grid.py::pallas_classified_grid_fn (the
// Pallas TPU kernel behind classified_grid_pallas). Outputs:
//   dist  f32 (nk, nj, ni)          every corner's distance;
//   cases u8  (nk-1, nj-1, ni-1)    the 8-sign-bit MC case of each cube,
//         0 where the corner-0 quick reject |d0| > thr (thr =
//         f32(2*1.73205080757) * res, computed on the host in float32)
//         or the case is 0 or 255 -- the TPU kernel's values
//         (gsdf_tpu/ops/mc_emit.py:168-187).
//
// The TPU kernel carried the previous z-plane across sequential grid
// steps in a VMEM ring. CUDA blocks run in no order, so here a block owns
// a (kBY x kBX) column of cubes over `kz` cube layers and marches z in a
// loop, keeping the previous corner plane in shared memory. It evaluates
// the +1 halo row and column of corners itself (and the first plane of
// its z-range, which the block below also evaluates): 297 corners per
// 256 cubes per plane. A halo corner is bit-identical to its owner's
// value because every position is origin + (float)global_index * res
// from the corner's global integer index -- never a per-block origin.
// Each corner's distance is written by exactly one block.
//
// What bounds it on the card: the ALU, on the tree's transcendentals and
// loops, as in K2; the writes are 4 B per corner plus 1 B per cube.
// Built with -fmad=false (see grid_eval.cu).
//
// k0 is the slab's first corner plane in the whole grid (the soup and
// compact paths' z-slab dispatch): plane k sits at oz + (float)(k0 + k) *
// res, from the global integer index, so a slab's corners equal the whole
// grid's bit for bit (the rule of gsdf_tpu/render/flat.py:87-92).
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"

namespace {

constexpr int kBX = 32;  // cubes per block along x
constexpr int kBY = 8;   // cubes per block along y
constexpr int kThreads = kBX * kBY;
constexpr int kPlane = (kBY + 1) * (kBX + 1);  // corners per plane tile

__global__ void __launch_bounds__(kThreads)
classified_grid_kernel(float* __restrict__ dist, uint8_t* __restrict__ cases,
                       float ox, float oy, float oz, float res, float thr,
                       int k0, int nk, int nj, int ni, int kz) {
    __shared__ float plane[2][kPlane];
    const int tid = threadIdx.x;
    const int i0 = blockIdx.x * kBX;
    const int j0 = blockIdx.y * kBY;
    const int kc0 = blockIdx.z * kz;          // first cube layer
    const int kc1 = min(kc0 + kz, nk - 1);    // corner plane past the last layer
    const int nx = ni - 1, ny = nj - 1;

    for (int k = kc0; k <= kc1; ++k) {
        float* cur = plane[(k - kc0) & 1];
        const float z = oz + (float)(k0 + k) * res;
        // plane kc1 is the next z-block's first plane unless it is the last
        const bool own_k = k < kc1 || k == nk - 1;
        for (int c = tid; c < kPlane; c += kThreads) {
            const int dj = c / (kBX + 1);
            const int di = c - dj * (kBX + 1);
            const int j = j0 + dj;
            const int i = i0 + di;
            float v = INFINITY;  // past the grid: sign bit 0, quick-rejected
            if (j < nj && i < ni) {
                v = gsdf_tree(ox + (float)i * res, oy + (float)j * res, z);
                if (own_k && (di < kBX || i == ni - 1) && (dj < kBY || j == nj - 1))
                    dist[((int64_t)k * nj + j) * ni + i] = v;
            }
            cur[c] = v;
        }
        __syncthreads();
        if (k > kc0) {
            const float* lo = plane[(k - 1 - kc0) & 1];
            const int tx = tid % kBX;
            const int ty = tid / kBX;
            const int i = i0 + tx;
            const int j = j0 + ty;
            if (i < nx && j < ny) {
                // corner order of gsdf_tpu/ops/mc_emit.py CORNER_OFFSETS
                const int a = ty * (kBX + 1) + tx;
                const float c0 = lo[a];
                const int cs = (int)(c0 < 0.0f)
                    | (int)(lo[a + 1] < 0.0f) << 1
                    | (int)(lo[a + kBX + 2] < 0.0f) << 2
                    | (int)(lo[a + kBX + 1] < 0.0f) << 3
                    | (int)(cur[a] < 0.0f) << 4
                    | (int)(cur[a + 1] < 0.0f) << 5
                    | (int)(cur[a + kBX + 2] < 0.0f) << 6
                    | (int)(cur[a + kBX + 1] < 0.0f) << 7;
                const bool keep = fabsf(c0) <= thr && cs != 0 && cs != 255;
                cases[((int64_t)(k - 1) * ny + j) * nx + i] = keep ? (uint8_t)cs : 0;
            }
        }
        __syncthreads();  // `lo` is overwritten by the next plane
    }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsdf_classified_grid(float* dist, uint8_t* cases, float ox,
                                    float oy, float oz, float res, float thr,
                                    int k0, int nk, int nj, int ni, int kz,
                                    void* stream) {
    if (nk < 2 || nj < 2 || ni < 2 || kz < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((ni - 1 + kBX - 1) / kBX, (nj - 1 + kBY - 1) / kBY,
                    (nk - 1 + kz - 1) / kz);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
    classified_grid_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        dist, cases, ox, oy, oz, res, thr, k0, nk, nj, ni, kz);
    return (int)cudaGetLastError();
}
