// K1: SDF grid evaluation + marching-cubes classification on Hopper.
//
// Replaces gsdf_tpu/eval/pallas_grid.py::pallas_classified_grid_fn (the
// Pallas TPU kernel behind classified_grid_pallas). Outputs:
//   dist  f32 (nk, nj, ni)          every corner's distance;
//   cases u8  (nk-1, nj-1, ni-1)    the 8-sign-bit MC case of each cube,
//         0 where the corner-0 quick reject |d0| > thr (thr =
//         f32(2*1.73205080757) * res, computed on the host in float32)
//         or the case is 0 or 255 -- the TPU kernel's values
//         (gsdf_tpu/ops/mc_emit.py:168-187), by the rule of
//         gsdf_case.cuh, which K6a (tile_atlas.cu) shares.
//
// What bounds it on the card: the ALU, on the tree's operations at every
// corner (gsdf_tpu_torch/bounds.py counts them); the bytes, 4 per corner
// and 1 per cube, take a sixth of that time or less on the main-path parts.
//
// The TPU kernel carried the previous z-plane across sequential grid
// steps in a VMEM ring. CUDA blocks run in no order, so a fused kernel
// needs a halo: evaluated twice (recompute) or shared through barriers
// (which serialise the tree evaluation, the costly part). Instead two
// launches on the stream:
//   (a) eval_kernel: one thread per corner, every corner evaluated once,
//       no barrier and no shared memory. Blocks tile each corner plane
//       (nj * ni, 32-bit) in runs of 256, the plane index in blockIdx.y,
//       so no thread divides in 64 bits and a plane's tail wastes at most
//       one block's worth of threads;
//   (b) classify_kernel: four consecutive cube ids per thread, one 4-byte
//       store. A cube's eight corners sit on four corner rows one row or
//       one plane apart; four cubes in one row read five values of each.
//       Neighbouring threads read neighbouring values, and the rows are
//       read again by the rows' other cubes from L2, which holds all of
//       `dist` for grids up to 50 MB (every main-path grid but flange
//       800, which reads it once more from device memory).
//
// Every position is origin + (float)global_index * res from the corner's
// global integer index, as in K2, so K1's distances equal K2's bit for bit.
// k0 is the slab's first corner plane in the whole grid (the soup and
// compact paths' z-slab dispatch): plane k sits at oz + (float)(k0 + k) *
// res, so a slab's corners equal the whole grid's bit for bit (the rule of
// gsdf_tpu/render/flat.py:87-92). Built with -fmad=false (see grid_eval.cu).
//
// The parametric form, K1p (gsdf_params.cuh): the same two launches
// around a parametric gsdf_tree(), which reads the tree's continuous
// parameters from the eval kernel's last argument; the classify pass never
// sees the tree. Counterpart of the operand-bound executables that the JAX
// package caches by structure (gsdf_tpu/eval/parametric.py:147-175 behind
// ops/compact_field.py and ops/fused_welded.py). The operations and their
// order are the baked form's, so its distances equal the baked form's bit
// for bit.
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"
#include "gsdf_params.cuh"
#include "gsdf_case.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCubes = 4;  // cube cases per classify thread: one 4-byte store

__global__ void __launch_bounds__(kThreads)
eval_kernel(float* __restrict__ dist, float ox, float oy, float oz, float res,
            int k0, int nj, int ni GSDF_PARAMS_DECL) {
    const unsigned plane = (unsigned)nj * (unsigned)ni;
    const unsigned c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= plane) return;
    const int j = (int)(c / (unsigned)ni);
    const int i = (int)(c - (unsigned)j * (unsigned)ni);
    const int k = (int)blockIdx.y;
    dist[(int64_t)k * plane + c] = GSDF_TREE(ox + (float)i * res, oy + (float)j * res,
                                             oz + (float)(k0 + k) * res);
}

// Cube i's case from the corner rows at (j, k), (j+1, k), (j, k+1), (j+1, k+1).
__device__ __forceinline__ unsigned row_case(const float* r00, const float* r10,
                                             const float* r01, const float* r11, int i,
                                             float thr) {
    return gsdf_cube_case(r00[i], r00[i + 1], r10[i + 1], r10[i], r01[i], r01[i + 1],
                          r11[i + 1], r11[i], thr);
}

__global__ void __launch_bounds__(kThreads)
classify_kernel(const float* __restrict__ dist, uint8_t* __restrict__ cases,
                float thr, int nk, int nj, int ni) {
    const int nx = ni - 1, ny = nj - 1;
    const unsigned n = (unsigned)nx * (unsigned)ny * (unsigned)(nk - 1);  // < 2^31
    const unsigned id0 = (blockIdx.x * kThreads + threadIdx.x) * kCubes;
    if (id0 >= n) return;
    const unsigned row = id0 / (unsigned)nx;  // cube row (k, j)
    int i = (int)(id0 - row * (unsigned)nx);
    int j = (int)(row % (unsigned)ny);
    int k = (int)(row / (unsigned)ny);
    const int64_t plane = (int64_t)nj * ni;
    const float* r00 = dist + (int64_t)k * plane + (int64_t)j * ni;
    unsigned word = 0;
    if (i + kCubes <= nx && id0 + kCubes <= n) {
        // the four cubes share one row: five values of each corner row
        float a[kCubes + 1], b[kCubes + 1], c[kCubes + 1], d[kCubes + 1];
#pragma unroll
        for (int t = 0; t <= kCubes; ++t) {
            a[t] = r00[i + t];
            b[t] = r00[ni + i + t];
            c[t] = r00[plane + i + t];
            d[t] = r00[plane + ni + i + t];
        }
#pragma unroll
        for (int q = 0; q < kCubes; ++q)
            word |= gsdf_cube_case(a[q], a[q + 1], b[q + 1], b[q], c[q], c[q + 1], d[q + 1],
                                   d[q], thr) << (8 * q);
    } else {
        for (int q = 0; q < kCubes && id0 + q < n; ++q) {
            word |= row_case(r00, r00 + ni, r00 + plane, r00 + plane + ni, i, thr) << (8 * q);
            if (++i == nx) {  // the run wraps to the next cube row
                i = 0;
                if (++j == ny) {
                    j = 0;
                    ++k;
                }
                r00 = dist + (int64_t)k * plane + (int64_t)j * ni;
            }
        }
    }
    if (id0 + kCubes <= n) {
        *reinterpret_cast<uint32_t*>(cases + id0) = word;  // 4-aligned: id0 % 4 == 0
    } else {
        for (unsigned q = 0; id0 + q < n; ++q) cases[id0 + q] = (uint8_t)(word >> (8 * q));
    }
}

}  // namespace

// Launches (a) then (b) on `stream`; returns cudaGetLastError() (0 =
// launched). `cases` must be 4-byte aligned (a fresh torch allocation).
// The parametric entry point also takes the parameter vector and its
// length, which must be the structure's: `params` is a host pointer where
// the vector goes by value (copied here, so the caller may free it when
// the call returns), else a device pointer that stays valid on `stream`.
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_classified_grid_param(float* dist, uint8_t* cases, float ox,
                                          float oy, float oz, float res, float thr,
                                          int k0, int nk, int nj, int ni,
                                          const float* params, int n_params,
                                          void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_classified_grid(float* dist, uint8_t* cases, float ox,
                                    float oy, float oz, float res, float thr,
                                    int k0, int nk, int nj, int ni, void* stream) {
#endif
    if (nk < 2 || nj < 2 || ni < 2) return (int)cudaErrorInvalidValue;
    const int64_t plane = (int64_t)nj * ni;
    const int64_t n_cubes = (int64_t)(nk - 1) * (nj - 1) * (ni - 1);
    if (plane > 0x7fffffffLL || n_cubes >= (1LL << 31) ||
        (reinterpret_cast<uintptr_t>(cases) & 3) != 0)
        return (int)cudaErrorInvalidValue;
    if (nk > 65535) return (int)cudaErrorInvalidConfiguration;
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 eval_grid((unsigned)((plane + kThreads - 1) / kThreads), (unsigned)nk);
    eval_kernel<<<eval_grid, kThreads, 0, s>>>(dist, ox, oy, oz, res, k0, nj,
                                               ni GSDF_PARAMS_ARG);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const int64_t per_block = (int64_t)kThreads * kCubes;
    classify_kernel<<<(unsigned)((n_cubes + per_block - 1) / per_block), kThreads, 0, s>>>(
        dist, cases, thr, nk, nj, ni);
    return (int)cudaGetLastError();
}
