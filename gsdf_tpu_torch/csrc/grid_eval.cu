// K2: dense SDF grid evaluation on Hopper.
//
// Replaces gsdf_tpu/eval/pallas_grid.py::pallas_grid_eval_fn (the Pallas
// TPU kernel behind evaluate_grid_pallas). One thread per grid corner:
// the position is synthesised from the corner's GLOBAL integer index,
// origin + (float)index * res (the slab rule of gsdf_tpu/render/flat.py:
// 87-92), the whole tree is evaluated by the generated gsdf_tree(), and
// 4 bytes are written. Layout [k, j, i], x contiguous, exactly
// (nk, nj, ni): no padding to slice off.
//
// What bounds it on the card: the ALU, on the tree's transcendentals
// (sqrtf, atan2f) and its loops (polygon edges, the showerhead's
// 130-offset union); the write is 4 B per corner. Built with -fmad=false
// so no multiply-add is contracted: every value rounds as the JAX
// package's expression does.
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
grid_eval_kernel(float* __restrict__ out, float ox, float oy, float oz,
                 float res, int k0, int nk, int nj, int ni) {
    const int64_t n = (int64_t)nk * nj * ni;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
         idx += stride) {
        const int i = (int)(idx % ni);
        const int64_t r = idx / ni;
        const int j = (int)(r % nj);
        const int k = (int)(r / nj) + k0;
        out[idx] = gsdf_tree(ox + (float)i * res, oy + (float)j * res,
                             oz + (float)k * res);
    }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsdf_grid_eval(float* out, float ox, float oy, float oz,
                              float res, int k0, int nk, int nj, int ni,
                              void* stream) {
    const int64_t n = (int64_t)nk * nj * ni;
    if (n <= 0) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    grid_eval_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        out, ox, oy, oz, res, k0, nk, nj, ni);
    return (int)cudaGetLastError();
}
