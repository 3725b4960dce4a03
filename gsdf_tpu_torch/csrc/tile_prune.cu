// K6c: the pruned renderer's coarse pass on Hopper.
//
// Replaces gsdf_tpu/render/pruned.py::_coarse_fn (:41-98), which XLA
// fused on the TPU: the tree's distance at the centre of every tile of
// S x S x S cubes, and the tile kept where |d| < S*res*sqrt(3)/2 (the
// reference's octree prune, octreerenderer.go:262). Outputs:
//   keep  u8 (tz, ty, tx)  1 where the tile is kept, else 0;
//   count i32              the kept tiles (zeroed here, then summed).
// The centre of tile (i, j, k) is, per axis and in float32, in the JAX
// package's order (pruned.py:58-66):
//   o + (float)idx * tres + half,  tres = f32(S) * res, half = tres * 0.5f,
// and the threshold thr = tres * f32(sqrt(3) / 2); the host rounds tres,
// half and thr in float32 as the JAX package does.
//
// What bounds it on the card: the ALU, on the tree's operations at every
// tile centre; it writes one byte a tile. The coarse grid is S^3 = 512
// times smaller than the fine one, so the launch and the host's read of
// the mask cost more than the work. A simple kernel: one thread per tile
// centre, no shared memory; each block adds its kept tiles to the count
// with one atomic (__syncthreads_count). Built with -fmad=false, so the
// keep mask equals the plain torch version's.
//
// The parametric form, K6cp (gsdf_params.cuh): the same kernel around a
// parametric gsdf_tree(), which reads the tree's continuous parameters
// from the kernel's last argument (the JAX side: _coarse_fn(parametric=
// True), the structure-cached executable).
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"
#include "gsdf_params.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
prune_kernel(uint8_t* __restrict__ keep, int* __restrict__ count, float ox, float oy,
             float oz, float tres, float half, float thr, int ty, int tx,
             unsigned n GSDF_PARAMS_DECL) {
    const unsigned c = blockIdx.x * kThreads + threadIdx.x;
    int kept = 0;
    if (c < n) {
        const unsigned row = c / (unsigned)tx;
        const int i = (int)(c - row * (unsigned)tx);
        const int j = (int)(row % (unsigned)ty);
        const int k = (int)(row / (unsigned)ty);
        const float d = GSDF_TREE(ox + (float)i * tres + half, oy + (float)j * tres + half,
                                  oz + (float)k * tres + half);
        kept = fabsf(d) < thr;
        keep[c] = (uint8_t)kept;
    }
    const int block_kept = __syncthreads_count(kept);
    if (threadIdx.x == 0 && block_kept) atomicAdd(count, block_kept);
}

}  // namespace

// Zeroes `count`, then launches on `stream`; returns cudaGetLastError()
// (0 = launched). The parametric entry point also takes the parameter
// vector (a host pointer where it goes by value, else a device pointer)
// and its length, which must be the structure's.
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_tile_prune_param(uint8_t* keep, int* count, float ox, float oy,
                                     float oz, float tres, float half, float thr, int tz,
                                     int ty, int tx, const float* params, int n_params,
                                     void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_tile_prune(uint8_t* keep, int* count, float ox, float oy, float oz,
                               float tres, float half, float thr, int tz, int ty, int tx,
                               void* stream) {
#endif
    if (tz < 1 || ty < 1 || tx < 1) return (int)cudaErrorInvalidValue;
    const long long n = (long long)tz * ty * tx;
    if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    int rc = (int)cudaMemsetAsync(count, 0, sizeof(int), s);
    if (rc != 0) return rc;
    prune_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        keep, count, ox, oy, oz, tres, half, thr, ty, tx, (unsigned)n GSDF_PARAMS_ARG);
    return (int)cudaGetLastError();
}
