// The tile-atlas id map on Hopper: K3's ascending atlas cube ids to the
// global cube ids of the whole grid.
//
// Replaces the id arithmetic of gsdf_tpu/ops/compact_field.py::
// tile_compact_emit (:311-319), which XLA fused on the TPU. K3
// (compact_active.cu) compacts the tile atlas's case grid, (T*P - 1, S, S)
// with P = S + 1 (tile_atlas.cu), so an atlas id a is
//   i = a % S, j = (a / S) % S, ka = a / S^2, tile t = ka / P, lk = ka % P,
// and, with `tiles` (T, 3) int32 [ti, tj, tk], its global id in the
// (nz, ny, nx) cube grid is
//   ((tk*S + lk) * ny + tj*S + j) * nx + ti*S + i.
// The atlas id stays where it is: K4 reads the atlas through it.
//
// What bounds it on the card: 8 bytes an active cube (read one id, write
// one), ~1-2% of the tiles' cubes; the launch costs more. One thread per
// id. The caller keeps every global id below 2^31 (the renderer refuses a
// grid of 2^31 cubes or more, as the JAX package does).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
global_ids_kernel(const int32_t* __restrict__ atlas_ids, long long A,
                  const int32_t* __restrict__ tiles, int S, int nx, int ny,
                  int32_t* __restrict__ out) {
    const long long a = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (a >= A) return;
    const unsigned id = (unsigned)__ldg(atlas_ids + a);
    const unsigned P = (unsigned)S + 1u;
    const unsigned row = id / (unsigned)S;
    const long long i = id - row * (unsigned)S;
    const long long j = row % (unsigned)S;
    const unsigned ka = row / (unsigned)S;
    const unsigned t = ka / P;
    const long long lk = ka - t * P;
    const int32_t* tile = tiles + 3 * t;
    out[a] = (int32_t)((((long long)__ldg(tile + 2) * S + lk) * ny + (long long)__ldg(tile + 1) * S
                        + j) * nx + (long long)__ldg(tile) * S + i);
}

}  // namespace

// out (A,) int32 global ids of the A atlas ids. Returns cudaGetLastError().
extern "C" int gsdf_tile_global_ids(const int32_t* atlas_ids, long long A, const int32_t* tiles,
                                    int S, int nx, int ny, int32_t* out, void* stream) {
    const long long blocks = (A + kThreads - 1) / kThreads;
    if (A <= 0 || blocks > 0x7fffffffLL || S < 1 || nx < 1 || ny < 1)
        return (int)cudaErrorInvalidValue;
    global_ids_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        atlas_ids, A, tiles, S, nx, ny, out);
    return (int)cudaGetLastError();
}
