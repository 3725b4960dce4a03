// The marching-cubes case byte of one cube, shared by K1
// (classified_grid.cu) and K6a (tile_atlas.cu): the pruned payload equals
// the dense one bit for bit because both kernels classify with this one
// rule.
//
// v0..v7 are the cube's corner distances in the corner order of
// gsdf_tpu/ops/mc_emit.py CORNER_OFFSETS; bit q of the case is v_q < 0.
// The case is 0 where the corner-0 quick reject |v0| > thr holds (thr =
// f32(2*1.73205080757) * res, computed on the host in float32) or where
// every corner has one sign (case 0 or 255): the TPU kernel's values
// (gsdf_tpu/ops/mc_emit.py:168-187).
#pragma once

__device__ __forceinline__ unsigned gsdf_cube_case(float v0, float v1, float v2, float v3,
                                                   float v4, float v5, float v6, float v7,
                                                   float thr) {
    const unsigned cs = (unsigned)(v0 < 0.0f) | (unsigned)(v1 < 0.0f) << 1
        | (unsigned)(v2 < 0.0f) << 2 | (unsigned)(v3 < 0.0f) << 3
        | (unsigned)(v4 < 0.0f) << 4 | (unsigned)(v5 < 0.0f) << 5
        | (unsigned)(v6 < 0.0f) << 6 | (unsigned)(v7 < 0.0f) << 7;
    return (fabsf(v0) <= thr && cs != 0u && cs != 255u) ? cs : 0u;
}
