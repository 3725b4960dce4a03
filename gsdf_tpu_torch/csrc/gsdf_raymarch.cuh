// K8's per-ray arithmetic: one supersample from its pixel index to its
// three u8 channels, and the integer box filter. Shared by the kernel
// (raymarch.cu) and a g++ test on the CPU (tests/test_torch_visual.py),
// which holds it against the plain torch version (eval/ray_kernels.py)
// pixel for pixel: every function is plain C++ that nvcc builds for the
// card and g++ for the host.
//
// Each expression keeps the JAX package's operations and their order
// (gsdf_tpu/visual/raymarch.py:60-148), built without multiply-add
// contraction (-fmad=false / -ffp-contract=off):
// - the ray: uv = ((2 ix - rw) / rh, -(2 iy - rh) / rh), rd = (uv_x uu +
//   uv_y vv) + 1.8 ww over sqrt((x*x + y*y) + z*z) (:60-88);
// - the scene: tree(p * scale + center) / scale (:65-66);
// - the march (:91-106): t moves by d * relax while |d| >= 1e-4; a ray is
//   done at a hit (t unchanged) or once the moved t passes the far plane.
//   The JAX package carries done rays through every step with t frozen;
//   here a done ray leaves the loop, which gives the same t;
// - the final distance, the hit |d| < 1e-3, the tetrahedral normal
//   ((k1 d1 + k2 d2) + k3 d3) + k4 d4 at h = 1e-4 over sqrt(|n|^2 + 1e-20)
//   (:108-123);
// - diffuse, ambient, spec^16 as four squarings (XLA's integer_pow), sky,
//   clip, ^(1/2.2) and truncation to u8 (:125-138);
// - the box filter (2 s + n) / (2 n) over the aa x aa u8 samples (:140-148).
//
// The tree is called at two sites only, the march loop and one loop over
// the five positions after it, so a large tree is inlined twice.
#pragma once
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define GSDF_RM_HD static __host__ __device__ __forceinline__
// the scene functor is a __device__ lambda in the kernel and a host
// functor in the CPU test: the templates take either
#define GSDF_RM_SCENE_HD _Pragma("nv_exec_check_disable") template <class Scene> GSDF_RM_HD
#else
#define GSDF_RM_HD static inline
#define GSDF_RM_SCENE_HD template <class Scene> GSDF_RM_HD
#endif

namespace gsdf_rm {

// One frame's constants, made once on the host in float32
// (visual/raymarch.py::camera); the plain version takes the same numbers.
struct Camera {
    float ro[3], uu[3], vv[3], ww[3];  // ray origin, camera basis
    float center[3], light[3];         // bounds centre, unit light direction
    float scale;                       // half the bounds' largest side
    float far_plane;                   // cam_dist + 4
};
constexpr int kCameraFloats = 20;
static_assert(sizeof(Camera) == kCameraFloats * sizeof(float), "Camera is 20 floats");

GSDF_RM_HD float clip01(float x) {  // jnp.clip / torch.clamp: NaN stays NaN
    return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// The unit ray direction of supersample (ix, iy) of an rw x rh frame.
GSDF_RM_HD void ray_dir(const Camera& c, int ix, int iy, int rw, int rh, float rd[3]) {
    const float w = (float)rw, h = (float)rh;
    const float ux = (2.0f * (float)ix - w) / h;
    const float uy = -(2.0f * (float)iy - h) / h;
    float r[3];
    for (int k = 0; k < 3; ++k) r[k] = (ux * c.uu[k] + uy * c.vv[k]) + 1.8f * c.ww[k];
    const float len = sqrtf((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]);
    for (int k = 0; k < 3; ++k) rd[k] = r[k] / len;
}

GSDF_RM_SCENE_HD float scene_at(Scene& scene, const Camera& c, float x, float y, float z) {
    return scene(x * c.scale + c.center[0], y * c.scale + c.center[1],
                 z * c.scale + c.center[2]) / c.scale;
}

// Sphere tracing: t at the end, and the tree evaluations it made.
GSDF_RM_SCENE_HD float march(Scene& scene, const Camera& c, const float rd[3], int steps,
                             float relax, int* evals) {
    float t = 0.0f;
    int i = 0;
#pragma unroll 1
    while (i < steps) {
        const float d = scene_at(scene, c, c.ro[0] + rd[0] * t, c.ro[1] + rd[1] * t,
                                 c.ro[2] + rd[2] * t);
        ++i;
        if (fabsf(d) < 1e-4f) break;
        t = t + d * relax;
        if (t > c.far_plane) break;
    }
    *evals = i;
    return t;
}

// The colour of a ray that stopped at t: five more tree evaluations (the
// final distance, then the four tetrahedral offsets), then the shading.
GSDF_RM_SCENE_HD void shade(Scene& scene, const Camera& c, const float rd[3], float t,
                            uint8_t rgb[3]) {
    const float pos[3] = {c.ro[0] + rd[0] * t, c.ro[1] + rd[1] * t, c.ro[2] + rd[2] * t};
    float d0 = 0.0f, n[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
    for (int q = 0; q < 5; ++q) {
        // k1 = (1, -1, -1), k2 = (-1, -1, 1), k3 = (-1, 1, -1), k4 = (1, 1, 1)
        const float k[3] = {(q == 1 || q == 4) ? 1.0f : -1.0f, q >= 3 ? 1.0f : -1.0f,
                            (q == 2 || q == 4) ? 1.0f : -1.0f};
        float p[3] = {pos[0], pos[1], pos[2]};
        if (q)
            for (int a = 0; a < 3; ++a) p[a] = pos[a] + k[a] * 1e-4f;
        const float d = scene_at(scene, c, p[0], p[1], p[2]);
        if (q == 0)
            d0 = d;
        else if (q == 1)
            for (int a = 0; a < 3; ++a) n[a] = k[a] * d;
        else
            for (int a = 0; a < 3; ++a) n[a] = n[a] + k[a] * d;
    }
    const bool hit = fabsf(d0) < 1e-3f;
    const float len = sqrtf(((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2]) + 1e-20f);
    for (int a = 0; a < 3; ++a) n[a] = n[a] / len;
    const float* l = c.light;
    const float dif = clip01((n[0] * l[0] + n[1] * l[1]) + n[2] * l[2]);
    const float amb = 0.5f + 0.5f * n[2];
    const float lit = 0.25f * amb + 0.8f * dif;
    const float rn2 = 2.0f * ((rd[0] * n[0] + rd[1] * n[1]) + rd[2] * n[2]);
    float r[3];
    for (int a = 0; a < 3; ++a) r[a] = rd[a] - rn2 * n[a];
    float spec = clip01((r[0] * l[0] + r[1] * l[1]) + r[2] * l[2]);
    spec = spec * spec;
    spec = spec * spec;
    spec = spec * spec;
    spec = spec * spec;
    const float base[3] = {0.85f, 0.6f, 0.3f};
    const float sky[3] = {0.65f, 0.78f, 0.9f};
    const float gamma = (float)(1.0 / 2.2);
    for (int a = 0; a < 3; ++a) {
        const float col = hit ? base[a] * lit + 0.15f * spec : sky[a] - 0.4f * rd[2];
        rgb[a] = (uint8_t)(powf(clip01(col), gamma) * 255.0f);
    }
}

// Supersample (ix, iy) of an rw x rh frame into rgb[3]; *evals gets the
// tree evaluations it made (its march's, and 5).
GSDF_RM_SCENE_HD void sample(Scene& scene, const Camera& c, int ix, int iy, int rw, int rh,
                             int steps, float relax, uint8_t rgb[3], int* evals) {
    float rd[3];
    ray_dir(c, ix, iy, rw, rh, rd);
    const float t = march(scene, c, rd, steps, relax, evals);
    shade(scene, c, rd, t, rgb);
    *evals += 5;
}

// Output pixel (x, y) of a width-wide frame from the (aa*H, aa*W, 3)
// samples: each channel (2 s + n) / (2 n), s the sum of its aa x aa
// samples and n = aa * aa, i.e. floor(mean + 0.5).
GSDF_RM_HD void box_filter(const uint8_t* in, uint8_t* out, int x, int y, int width, int aa) {
    const int rw = width * aa, n = aa * aa;
    for (int a = 0; a < 3; ++a) {
        int s = 0;
        for (int dy = 0; dy < aa; ++dy)
            for (int dx = 0; dx < aa; ++dx)
                s += in[3 * ((int64_t)(y * aa + dy) * rw + x * aa + dx) + a];
        out[3 * ((int64_t)y * width + x) + a] = (uint8_t)((2 * s + n) / (2 * n));
    }
}

}  // namespace gsdf_rm
