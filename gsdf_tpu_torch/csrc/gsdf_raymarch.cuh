// K8's per-ray arithmetic: one supersample from its pixel index to its
// three u8 channels, a tree evaluation at a time, the order of the
// kernel's ray queue, and the integer box filter. Shared by the kernel
// (raymarch.cu) and a g++ test on the CPU (tests/test_torch_visual.py),
// which drives it from a host scheduler that mirrors the kernel's warp
// and holds it against the plain torch version (eval/ray_kernels.py)
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
//   here a done ray stops marching, which gives the same t;
// - the final distance, the hit |d| < 1e-3, the tetrahedral normal
//   ((k1 d1 + k2 d2) + k3 d3) + k4 d4 at h = 1e-4 over sqrt(|n|^2 + 1e-20)
//   (:108-123);
// - diffuse, ambient, spec^16 as four squarings (XLA's integer_pow), sky,
//   clip, ^(1/2.2) and truncation to u8 (:125-138);
// - the box filter (2 s + n) / (2 n) over the aa x aa u8 samples (:140-148).
//
// A ray is made once (ray_dir); a lane marches it (march_point,
// march_step); then its five shading evaluations (the final distance and
// the four tetrahedral offsets: shade_point, shade_step) and its colour
// (shade). A caller evaluates the tree at one call site for all of them.
#pragma once
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define GSDF_RM_HD static __host__ __device__ __forceinline__
// the scene functor is a __device__ lambda in the kernel and a host
// functor in the CPU test: the template takes either
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

// The ray queue's order: tiles of kTileW x kTileH supersamples, row-major
// over the frame, each tile's rays row-major inside it, so the 32 ids a
// warp takes together are one tile of neighbours. The tiles cover the
// frame's ragged edge; an id there is no ray.
constexpr int kTileW = 8, kTileH = 4;
static_assert(kTileW * kTileH == 32, "a tile is one warp's batch of ids");

// The ids of an rw x rh frame's queue, its edge tiles' whole.
GSDF_RM_HD int64_t queue_length(int rw, int rh) {
    return (int64_t)((rw + kTileW - 1) / kTileW) * ((rh + kTileH - 1) / kTileH) * 32;
}

// The supersample (ix, iy) of queue id `id` (0 <= id < queue_length);
// false past the frame's edge.
GSDF_RM_HD bool queue_ray(int id, int rw, int rh, int* ix, int* iy) {
    const int tiles_x = (rw + kTileW - 1) / kTileW;
    const int tile = id / 32, in = id % 32;
    *ix = tile % tiles_x * kTileW + in % kTileW;
    *iy = tile / tiles_x * kTileH + in / kTileW;
    return *ix < rw && *iy < rh;
}

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

// Axis a of the tetrahedral offset of shading evaluation q = 1..4:
// k1 = (1, -1, -1), k2 = (-1, -1, 1), k3 = (-1, 1, -1), k4 = (1, 1, 1).
GSDF_RM_HD float normal_k(int q, int a) {
    const bool plus = a == 0 ? (q == 1 || q == 4) : a == 1 ? q >= 3 : (q == 2 || q == 4);
    return plus ? 1.0f : -1.0f;
}

// One lane's marching ray.
struct Lane {
    float rd[3];  // unit direction
    float t;      // distance along the ray
    int steps;    // march evaluations made
    int at;       // the supersample's index iy * rw + ix in the frame
};

GSDF_RM_HD void lane_start(Lane& l, const float rd[3], int at) {
    for (int a = 0; a < 3; ++a) l.rd[a] = rd[a];
    l.t = 0.0f;
    l.steps = 0;
    l.at = at;
}

// The point of the lane's next march step, in the scene's unit frame.
GSDF_RM_HD void march_point(const Lane& l, const Camera& c, float p[3]) {
    for (int a = 0; a < 3; ++a) p[a] = c.ro[a] + l.rd[a] * l.t;
}

// tree(p * scale + center) / scale at a point p of the unit frame.
GSDF_RM_SCENE_HD float scene_at(Scene& scene, const Camera& c, const float p[3]) {
    return scene(p[0] * c.scale + c.center[0], p[1] * c.scale + c.center[1],
                 p[2] * c.scale + c.center[2]) / c.scale;
}

// Moves the lane on by the distance d at its march_point: a hit keeps t,
// a miss moves t by d * relax. True once the march is over: at a hit,
// past the far plane or at the step limit (a ray with steps = 0 marches
// none and is over from the start).
GSDF_RM_HD bool march_step(Lane& l, const Camera& c, float d, int steps, float relax) {
    ++l.steps;
    if (fabsf(d) < 1e-4f) return true;
    l.t = l.t + d * relax;
    return l.t > c.far_plane || l.steps >= steps;
}

// The point of shading evaluation q of a ray that stopped at the unit
// frame's point pos (ro + rd t): pos itself (q = 0, the final distance),
// then pos + k_q h (q = 1..4, the tetrahedral offsets).
GSDF_RM_HD void shade_point(const float pos[3], int q, float p[3]) {
    for (int a = 0; a < 3; ++a) p[a] = q > 0 ? pos[a] + normal_k(q, a) * 1e-4f : pos[a];
}

// Takes the distance d of shading evaluation q into the final distance
// d0 (q = 0) or the normal's sum ((k1 d1 + k2 d2) + k3 d3) + k4 d4.
GSDF_RM_HD void shade_step(int q, float d, float* d0, float n[3]) {
    if (q == 0)
        *d0 = d;
    else if (q == 1)
        for (int a = 0; a < 3; ++a) n[a] = normal_k(1, a) * d;
    else
        for (int a = 0; a < 3; ++a) n[a] = n[a] + normal_k(q, a) * d;
}

// The colour of a done ray from its direction, its normal's sum and its
// final distance: the hit test, the normal, the shading.
GSDF_RM_HD void shade(const Camera& c, const float rd[3], const float n_sum[3], float d0,
                      uint8_t rgb[3]) {
    const bool hit = fabsf(d0) < 1e-3f;
    const float len =
        sqrtf(((n_sum[0] * n_sum[0] + n_sum[1] * n_sum[1]) + n_sum[2] * n_sum[2]) + 1e-20f);
    float n[3];
    for (int a = 0; a < 3; ++a) n[a] = n_sum[a] / len;
    const float* li = c.light;
    const float dif = clip01((n[0] * li[0] + n[1] * li[1]) + n[2] * li[2]);
    const float amb = 0.5f + 0.5f * n[2];
    const float lit = 0.25f * amb + 0.8f * dif;
    const float rn2 = 2.0f * ((rd[0] * n[0] + rd[1] * n[1]) + rd[2] * n[2]);
    float r[3];
    for (int a = 0; a < 3; ++a) r[a] = rd[a] - rn2 * n[a];
    float spec = clip01((r[0] * li[0] + r[1] * li[1]) + r[2] * li[2]);
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
