// Dual contouring's per-edge and per-voxel arithmetic, shared by K5
// (dc_mesh.cu) and a g++ test on the CPU (tests/test_torch_dual_contour.py),
// which holds it against the plain torch version (ops/dc_emit.py): every
// function is plain C++ that nvcc builds for the card and g++ for the host.
//
// Each expression keeps the JAX package's operations and their order
// (gsdf_tpu/render/dual_contour.py:221-474), built without multiply-add
// contraction (-fmad=false / -ffp-contract=off):
// - an edge is active where the sign BITS of its ends differ (-0.0 counts
//   as negative), t = -d0 / (de - d0, or 1 where de == d0), flip =
//   (de - d0) < 0 (:225-239);
// - a voxel's 13 sums (the upper triangle of N^T N, N^T (N q), the q sum
//   and the row count) add one row at a time, left to right (:351-364);
// - the 3x3 solve shifts to the bias point and runs 5 Jacobi sweeps over
//   (0,1), (0,2), (1,2), floors the spectrum at max(l2, 1e-6 * trace) and
//   clamps to [-0.1, 1.1] (:366-467).
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define GSDF_QEF_HD static __host__ __device__ __forceinline__
#else
#define GSDF_QEF_HD static inline
#endif

// The Jacobi rotation's functions: CUDA's precise ones on the card. A host
// build may name others (the CPU test names the plain version's: float64,
// rounded once).
#ifndef GSDF_QEF_ATAN2
#define GSDF_QEF_ATAN2 atan2f
#define GSDF_QEF_COS cosf
#define GSDF_QEF_SIN sinf
#endif

namespace gsdf_dc {

constexpr int kSums = 13;
constexpr int kSweeps = 5;

// The position of grid corner (i, j, k): origin + (float)index * res, as
// K2 (grid_eval.cu) makes it from the global index.
GSDF_QEF_HD void corner_position(float ox, float oy, float oz, float res, int i, int j, int k,
                                 float* p) {
    p[0] = ox + (float)i * res;
    p[1] = oy + (float)j * res;
    p[2] = oz + (float)k * res;
}

GSDF_QEF_HD bool sign_bit(float x) {
#ifdef __CUDA_ARCH__
    return (__float_as_uint(x) >> 31) != 0u;
#else
    uint32_t u;
    memcpy(&u, &x, sizeof u);
    return (u >> 31) != 0u;
#endif
}

// An edge from its voxel's corner (d0) to the next corner along its axis (de).
GSDF_QEF_HD bool edge_active(float d0, float de) { return sign_bit(d0) != sign_bit(de); }

GSDF_QEF_HD float edge_t(float d0, float de) { return -d0 / (de == d0 ? 1.0f : de - d0); }

GSDF_QEF_HD bool edge_flip(float d0, float de) { return (de - d0) < 0.0f; }

// One contribution row: normal n, crossing q in the voxel's normalised
// coordinates.
GSDF_QEF_HD void qef_add(float* s, const float* n, const float* q) {
    const float ndq = (n[0] * q[0] + n[1] * q[1]) + n[2] * q[2];
    s[0] += n[0] * n[0];
    s[1] += n[0] * n[1];
    s[2] += n[0] * n[2];
    s[3] += n[1] * n[1];
    s[4] += n[1] * n[2];
    s[5] += n[2] * n[2];
    s[6] += n[0] * ndq;
    s[7] += n[1] * ndq;
    s[8] += n[2] * ndq;
    s[9] += q[0];
    s[10] += q[1];
    s[11] += q[2];
    s[12] += 1.0f;
}

// The clamped solution x (normalised voxel coordinates) of one voxel's
// sums, with l2 the squared regularisation row weight.
GSDF_QEF_HD void qef_solve(const float* s, float l2, float* x) {
    const float cnt = fmaxf(s[12], 1.0f);
    const float bias[3] = {s[9] / cnt, s[10] / cnt, s[11] / cnt};
    // M + l2 I, upper triangle; the right-hand side shifted to the bias
    float m[3][3];
    m[0][0] = s[0] + l2;
    m[0][1] = s[1];
    m[0][2] = s[2];
    m[1][1] = s[3] + l2;
    m[1][2] = s[4];
    m[2][2] = s[5] + l2;
    m[1][0] = m[0][1];
    m[2][0] = m[0][2];
    m[2][1] = m[1][2];
    const float rhs[3] = {
        s[6] - ((s[0] * bias[0] + m[0][1] * bias[1]) + m[0][2] * bias[2]),
        s[7] - ((m[0][1] * bias[0] + s[3] * bias[1]) + m[1][2] * bias[2]),
        s[8] - ((m[0][2] * bias[0] + m[1][2] * bias[1]) + s[5] * bias[2]),
    };
    const float tr = (m[0][0] + m[1][1]) + m[2][2];
    float v[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
    const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (int sweep = 0; sweep < kSweeps; ++sweep) {
        for (int r = 0; r < 3; ++r) {
            const int p = pairs[r][0], q = pairs[r][1], o = 3 - p - q;
            const float app = m[p][p], aqq = m[q][q], apq = m[p][q];
            const float theta = 0.5f * GSDF_QEF_ATAN2(2.0f * apq, aqq - app);
            const float c = GSDF_QEF_COS(theta), sn = GSDF_QEF_SIN(theta);
            const float aop = m[o][p], aoq = m[o][q];
            const float c2 = c * c, s2 = sn * sn, cs = c * sn;
            const float napp = (c2 * app - 2.0f * cs * apq) + s2 * aqq;
            const float naqq = (s2 * app + 2.0f * cs * apq) + c2 * aqq;
            const float napq = cs * (app - aqq) + (c2 - s2) * apq;
            const float naop = c * aop - sn * aoq;
            const float naoq = sn * aop + c * aoq;
            m[p][p] = napp;
            m[q][q] = naqq;
            m[p][q] = m[q][p] = napq;
            m[o][p] = m[p][o] = naop;
            m[o][q] = m[q][o] = naoq;
            for (int row = 0; row < 3; ++row) {
                const float vp = v[row][p], vq = v[row][q];
                v[row][p] = c * vp - sn * vq;
                v[row][q] = sn * vp + c * vq;
            }
        }
    }
    // eigenvalues below the accumulated float32 noise of M count as zero
    const float floor = fmaxf(l2, 1e-6f * tr);
    float t[3];
    for (int c = 0; c < 3; ++c)
        t[c] = (((0.0f + v[0][c] * rhs[0]) + v[1][c] * rhs[1]) + v[2][c] * rhs[2]) /
               (fmaxf(m[c][c], 0.0f) + floor);
    for (int r = 0; r < 3; ++r) {
        const float y = ((0.0f + v[r][0] * t[0]) + v[r][1] * t[1]) + v[r][2] * t[2];
        x[r] = fminf(fmaxf(bias[r] + y, -0.1f), 1.1f);
    }
}

}  // namespace gsdf_dc
