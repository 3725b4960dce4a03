// KP: SDF distances at given points on Hopper, for 3D and 2D trees.
//
// Replaces the XLA-jitted tree.distance behind the JAX package's point
// evaluators (gsdf_tpu/eval/evaluator.py::_get_compiled, run by
// SDF3/SDF2.evaluate): positions (n, GSDF_NDIM) float32 in, distances
// (n,) float32 out, the one device contract of the Go original (a
// positions buffer in, a distances buffer out). n is a launch argument,
// so no batch is padded to a bucket.
//
// One thread per point. A block of 256 threads first copies its 256
// points into shared memory as consecutive words (a thread reading its
// own x, y, z from device memory would stride by 12 bytes), then each
// thread evaluates the generated gsdf_tree() on its point and writes 4
// bytes. Tiles of 256 points are walked grid-stride, so any n launches.
//
// What bounds it on the card: the ALU for every tree but the smallest
// (the flange is 336 operations a point against 16 bytes moved); a bare
// primitive is bound by its 4 * GSDF_NDIM + 4 bytes a point. Built with
// -fmad=false, and gsdf_tree() is inlined as in the grid kernels, so a
// point at a grid corner's position gets the grid kernel's distance bit
// for bit.
//
// The parametric form, KPp (gsdf_params.cuh): the same kernel around a
// parametric gsdf_tree(), which reads the tree's continuous parameters
// from the kernel's last argument. Counterpart of the jit behind the JAX
// package's ParametricSDF3/2 (gsdf_tpu/eval/parametric.py:147-175). Same
// operations in the same order as the baked form: the same distances bit
// for bit.
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py
// and defines GSDF_NDIM.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"
#include "gsdf_params.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
point_eval_kernel(const float* __restrict__ pos, int64_t n,
                  float* __restrict__ out GSDF_PARAMS_DECL) {
    __shared__ float stage[kThreads * GSDF_NDIM];
    const int64_t tiles = (n + kThreads - 1) / kThreads;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t first = tile * kThreads;
        const int64_t left = n - first;
        const int count = left < kThreads ? (int)left : kThreads;
        const float* __restrict__ src = pos + first * GSDF_NDIM;
        for (int w = threadIdx.x; w < count * GSDF_NDIM; w += kThreads)
            stage[w] = __ldg(src + w);
        __syncthreads();
        if ((int)threadIdx.x < count) {
            const float* p = stage + threadIdx.x * GSDF_NDIM;
#if GSDF_NDIM == 2
            out[first + threadIdx.x] = GSDF_TREE(p[0], p[1]);
#else
            out[first + threadIdx.x] = GSDF_TREE(p[0], p[1], p[2]);
#endif
        }
        __syncthreads();  // the stage is free for the next tile
    }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched). The
// parametric entry point also takes the parameter vector (a host pointer
// where it goes by value, else a device pointer) and its length, which
// must be the structure's.
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_point_eval_param(const float* pos, int64_t n, float* out,
                                     const float* params, int n_params, void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_point_eval(const float* pos, int64_t n, float* out, void* stream) {
#endif
    if (n <= 0) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    point_eval_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        pos, n, out GSDF_PARAMS_ARG);
    return (int)cudaGetLastError();
}
