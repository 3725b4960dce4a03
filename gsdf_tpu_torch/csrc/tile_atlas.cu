// K6a: the pruned renderer's fine pass on Hopper, the tile atlas.
//
// Replaces gsdf_tpu/render/pruned.py::_tile_grid (:101-142) with the tile
// classification of gsdf_tpu/ops/compact_field.py::tile_compact_emit
// (:288-303), which XLA fused on the TPU. For T kept tiles of S x S x S
// cubes (P = S + 1 corner planes a side), `tiles` (T, 3) int32 [i, j, k]
// tile coordinates, it writes
//   dist  f32 (T*P, P, P)      every tile's corners, tile t's corner plane
//                               lk at atlas plane t*P + lk: an ordinary
//                               [k, j, i] grid for K3 and K4;
//   cases u8  (T*P - 1, S, S)  the MC case of each atlas cube by K1's
//                               own effective-case rule (gsdf_case.cuh:
//                               corner-0 quick reject |d0| > thr, case 0
//                               or 255), and 0 on the
//                               seam layer between two tiles (local k =
//                               S, no cube of the part) and on every cube
//                               past the global grid (gi >= nx, gj >= ny or
//                               gk >= nz: edge tiles overhang where S does
//                               not divide the grid).
// Every position comes from the corner's GLOBAL integer index, origin +
// (float)(tile * S + local) * res, by K1's formula, so each atlas value
// equals K1's at the same corner bit for bit and the pruned payload equals
// the dense one (tests/test_pruned.py::test_pruned_compact_payload_
// bitexact_accel). K3 read over this case grid returns the active atlas
// cubes in ascending order, which is the JAX package's tile-major slot
// order of its (T, S, S, S) classification.
//
// What bounds it on the card: the ALU, on the tree's operations at every
// atlas corner ((S+1)^3 / S^3 = 1.42 evaluations a cube at S = 8; a corner
// shared by two tiles is evaluated in each, as in the JAX package). A
// simple kernel, as K1 is: two launches on the stream, (a) one thread per
// atlas corner, (b) one thread per atlas cube, one byte a thread.
//
// The parametric form, K6ap (gsdf_params.cuh): the same two launches
// around a parametric gsdf_tree() (the JAX side: _tile_compact_fn(
// parametric=True), the structure-cached executable). Built with
// -fmad=false, so both equal the plain torch version bit for bit.
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

__global__ void __launch_bounds__(kThreads)
atlas_eval_kernel(float* __restrict__ dist, const int32_t* __restrict__ tiles, int S,
                  float ox, float oy, float oz, float res, unsigned n GSDF_PARAMS_DECL) {
    const unsigned c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= n) return;
    const unsigned P = (unsigned)S + 1u, P2 = P * P;
    const unsigned t = c / (P2 * P);
    const unsigned r = c - t * (P2 * P);
    const unsigned row = r / P;  // lk * P + lj
    const int li = (int)(r - row * P), lj = (int)(row % P), lk = (int)(row / P);
    const int32_t* tile = tiles + 3 * t;
    const int gi = __ldg(tile) * S + li;
    const int gj = __ldg(tile + 1) * S + lj;
    const int gk = __ldg(tile + 2) * S + lk;
    dist[c] = GSDF_TREE(ox + (float)gi * res, oy + (float)gj * res, oz + (float)gk * res);
}

// A cube's case from its low corner's address in the atlas (P values a
// corner row, P * P a plane), by K1's rule (gsdf_case.cuh).
__device__ __forceinline__ unsigned atlas_case(const float* v, int P, float thr) {
    const int P2 = P * P;
    return gsdf_cube_case(v[0], v[1], v[P + 1], v[P], v[P2], v[P2 + 1], v[P2 + P + 1],
                          v[P2 + P], thr);
}

__global__ void __launch_bounds__(kThreads)
atlas_classify_kernel(const float* __restrict__ dist, uint8_t* __restrict__ cases,
                      const int32_t* __restrict__ tiles, int S, int nx, int ny, int nz,
                      float thr, unsigned n) {
    const unsigned id = blockIdx.x * kThreads + threadIdx.x;
    if (id >= n) return;
    const unsigned P = (unsigned)S + 1u;
    const unsigned row = id / (unsigned)S;
    const int i = (int)(id - row * (unsigned)S);
    const int j = (int)(row % (unsigned)S);
    const unsigned ka = row / (unsigned)S;  // atlas corner plane of the cube's low face
    const unsigned t = ka / P;
    const int lk = (int)(ka - t * P);
    unsigned c = 0;
    if (lk < S) {  // lk == S: the seam between tile t and tile t + 1
        const int32_t* tile = tiles + 3 * t;
        if (__ldg(tile) * S + i < nx && __ldg(tile + 1) * S + j < ny &&
            __ldg(tile + 2) * S + lk < nz)
            c = atlas_case(dist + ((size_t)ka * P + (unsigned)j) * P + (unsigned)i, (int)P, thr);
    }
    cases[id] = (uint8_t)c;
}

}  // namespace

// Launches (a) then (b) on `stream`; returns cudaGetLastError() (0 =
// launched). `tiles` (T, 3) int32 on the device. The parametric entry
// point also takes the parameter vector (a host pointer where it goes by
// value, else a device pointer) and its length, which must be the
// structure's.
#ifdef GSDF_PARAMETRIC
extern "C" int gsdf_tile_atlas_param(float* dist, uint8_t* cases, const int32_t* tiles, int T,
                                     int S, int nx, int ny, int nz, float ox, float oy,
                                     float oz, float res, float thr, const float* params,
                                     int n_params, void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_tile_atlas(float* dist, uint8_t* cases, const int32_t* tiles, int T, int S,
                               int nx, int ny, int nz, float ox, float oy, float oz, float res,
                               float thr, void* stream) {
#endif
    if (T < 1 || S < 1 || nx < 1 || ny < 1 || nz < 1) return (int)cudaErrorInvalidValue;
    const long long P = S + 1;
    const long long n_corners = (long long)T * P * P * P;
    const long long n_cubes = ((long long)T * P - 1) * S * S;
    if (n_corners >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    atlas_eval_kernel<<<(unsigned)((n_corners + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        dist, tiles, S, ox, oy, oz, res, (unsigned)n_corners GSDF_PARAMS_ARG);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    atlas_classify_kernel<<<(unsigned)((n_cubes + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        dist, cases, tiles, S, nx, ny, nz, thr, (unsigned)n_cubes);
    return (int)cudaGetLastError();
}
