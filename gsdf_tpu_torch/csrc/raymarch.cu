// K8: the raymarcher on Hopper, sphere tracing a tree to a shaded u8 image.
//
// Replaces the XLA-jitted `_raymarch_fn` of the JAX package
// (gsdf_tpu/visual/raymarch.py:26-181): for each of the (aa*H) x (aa*W)
// supersamples a ray from the pixel index and the camera basis, sphere
// tracing for at most `steps` steps, the final distance and the hit test,
// tetrahedral normals (four more tree evaluations), the shading, gamma and
// truncation to u8; where aa > 1, the integer box filter down to H x W.
// The per-ray arithmetic is gsdf_raymarch.cuh, in the JAX package's order.
//
// One thread per supersample, in 16 x 8 blocks: a warp holds 16 x 2
// neighbouring rays, which tend to march alike. A ray that is done leaves
// its loop (what the JAX package's masked fori_loop computes: a done ray's
// t never changes), so a warp runs as long as its slowest ray. The tree is
// inlined at two call sites: the march loop and one loop over the five
// positions after it.
//
// What bounds it on the card: the ALU, (evaluations) x (the tree's
// operations per point) plus the shading; the bytes are 3 a pixel out
// (the samples stay in device memory only where aa > 1). Sky rays,
// silhouette rays and hit rays finish at different steps, so a warp idles
// on its early rays: divergence, not memory, is what separates the kernel
// from that bound (PERF.md §7).
//
// width, height, steps, relax, aa and the camera are launch arguments:
// one library serves a tree at every frame size, step count and aa (the
// JAX package compiles one executable per (tree, w, h, steps, relax, aa)).
// The camera (20 floats) goes by value as a __grid_constant__ struct: no
// upload. A frame is one launch, two where aa > 1 (march into the samples,
// then the box filter).
//
// The parametric form, K8p (gsdf_params.cuh): the same kernel around a
// parametric gsdf_tree(), which reads the tree's continuous parameters
// from the kernel's last argument, one library per tree structure: the
// viewer's slider edits re-render with no build. Counterpart of
// `_raymarch_fn(parametric=True)` (raymarch.py:150-169).
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "gsdf_tree.cuh"
#include "gsdf_params.cuh"
#include "gsdf_raymarch.cuh"

namespace {

constexpr int kBX = 16, kBY = 8;

__global__ void __launch_bounds__(kBX * kBY)
raymarch_kernel(uint8_t* __restrict__ samples, int* __restrict__ evals, int rw, int rh,
                int steps, float relax,
                const __grid_constant__ gsdf_rm::Camera cam GSDF_PARAMS_DECL) {
    const int ix = blockIdx.x * kBX + threadIdx.x;
    const int iy = blockIdx.y * kBY + threadIdx.y;
    if (ix >= rw || iy >= rh) return;
    auto scene = [&](float x, float y, float z) { return GSDF_TREE(x, y, z); };
    const int64_t at = (int64_t)iy * rw + ix;
    uint8_t rgb[3];
    int n;
    gsdf_rm::sample(scene, cam, ix, iy, rw, rh, steps, relax, rgb, &n);
    samples[3 * at] = rgb[0];
    samples[3 * at + 1] = rgb[1];
    samples[3 * at + 2] = rgb[2];
    if (evals != nullptr) evals[at] = n;
}

__global__ void __launch_bounds__(kBX * kBY)
box_filter_kernel(const uint8_t* __restrict__ samples, uint8_t* __restrict__ out, int width,
                  int height, int aa) {
    const int x = blockIdx.x * kBX + threadIdx.x;
    const int y = blockIdx.y * kBY + threadIdx.y;
    if (x >= width || y >= height) return;
    gsdf_rm::box_filter(samples, out, x, y, width, aa);
}

}  // namespace

// samples (aa*height, aa*width, 3) u8; out (height, width, 3) u8, the
// samples themselves where aa == 1; evals (aa*height, aa*width) int32
// tree evaluations per supersample, or null; cam the 20 floats of
// gsdf_rm::Camera (a host pointer). Launches on `stream`; returns
// cudaGetLastError() (0 = launched). The parametric entry point also takes
// the parameter vector (a host pointer where it goes by value, else a
// device pointer) and its length, which must be the structure's.
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_raymarch_param(uint8_t* samples, uint8_t* out, int* evals, const float* cam,
                                   int width, int height, int steps, float relax, int aa,
                                   const float* params, int n_params, void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_raymarch(uint8_t* samples, uint8_t* out, int* evals, const float* cam,
                             int width, int height, int steps, float relax, int aa,
                             void* stream) {
#endif
    if (width < 1 || height < 1 || steps < 0 || aa < 1 || cam == nullptr ||
        (int64_t)width * aa > (1 << 20) || (int64_t)height * aa > 65535 * kBY ||
        (aa == 1) != (samples == out))
        return (int)cudaErrorInvalidValue;
    gsdf_rm::Camera c;
    memcpy(&c, cam, sizeof c);
    const int rw = width * aa, rh = height * aa;
    const dim3 block(kBX, kBY);
    raymarch_kernel<<<dim3((rw + kBX - 1) / kBX, (rh + kBY - 1) / kBY), block, 0,
                      (cudaStream_t)stream>>>(samples, evals, rw, rh, steps, relax,
                                              c GSDF_PARAMS_ARG);
    if (aa > 1) {
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
        box_filter_kernel<<<dim3((width + kBX - 1) / kBX, (height + kBY - 1) / kBY), block, 0,
                            (cudaStream_t)stream>>>(samples, out, width, height, aa);
    }
    return (int)cudaGetLastError();
}
