// K2-2D: a 2D tree's distance field on an image's pixel grid, on Hopper.
//
// Replaces the XLA-jitted tree.distance on a host-made pixel grid behind
// gsdf_tpu/render/image.py::render_distance_field: there the host builds
// a (h * w, 2) positions array and uploads it; here the positions are
// made in the kernel and no positions array exists. One thread per
// pixel: pixel (i, j), row 0 at the top, sits at
//
//     (xmin + (float)i * dx, ymax - (float)j * dy)
//
// with xmin, ymax, dx, dy computed by the host in float32 as the JAX
// package computes them. Built with -fmad=false, so the product and the
// sum round one after the other, as numpy's xmin + arange(w) * dx does:
// the positions equal the reference's bit for bit. Layout [j, i], x
// contiguous, exactly (h, w).
//
// What bounds it on the card: the ALU (the tree's operations a pixel)
// unless the tree is a bare primitive; the write is 4 B a pixel.
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <cstdint>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"

#if GSDF_NDIM != 2
#error "grid_eval_2d.cu is the template for 2D trees"
#endif

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
grid_eval_2d_kernel(float* __restrict__ out, float xmin, float ymax, float dx,
                    float dy, int w, int h) {
    const int64_t n = (int64_t)w * h;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
         idx += stride) {
        const int i = (int)(idx % w);
        const int j = (int)(idx / w);
        out[idx] = gsdf_tree(xmin + (float)i * dx, ymax - (float)j * dy);
    }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int gsdf_grid_eval_2d(float* out, float xmin, float ymax, float dx,
                                 float dy, int w, int h, void* stream) {
    const int64_t n = (int64_t)w * h;
    if (w <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
    grid_eval_2d_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        out, xmin, ymax, dx, dy, w, h);
    return (int)cudaGetLastError();
}
