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
// What bounds it on the card: the ALU, (evaluations) x (the tree's
// operations per point) plus the shading; the bytes are 3 a pixel out
// (the samples stay in device memory only where aa > 1). Rays end after
// very different numbers of steps (sky, silhouette, hit: 6 to steps + 5
// evaluations), so a kernel that gives each thread one ray idles twice:
// a warp marches as long as its slowest ray, and a block holds its SM
// slot until its slowest warp ends, which leaves the SMs idle in the
// launch's last wave (PERF.md §6).
//
// The design: persistent warps over a ray queue. One launch of as many
// 128-thread blocks as the card holds at once (SMs x resident blocks,
// read once per library and device through the occupancy API), fewer on
// a frame with fewer rays. Each warp takes ray ids from one global
// counter, 32 at a time with one atomic; the ids run over tiles of 8 x 4
// neighbouring supersamples (gsdf_rm::queue_ray), so a batch is a tile
// that tends to march alike. Each lane marches one ray (gsdf_rm::Lane:
// direction, t, step count, frame index). A lane whose march is over
// leaves the ray on the warp's stack and takes the next ray of the
// warp's batch at once: the idle lanes take consecutive rays by ballot
// and popc, and the warp takes a new batch only where its batch runs
// out. Once 32 rays are on the stack (or the queue is empty), the warp
// gives them their five shading evaluations together, a ray a lane, in
// five turns of the same loop, and shades them. Every turn of the loop
// computes each lane's point (its march point, or its stacked ray's hit
// point plus offset q), evaluates the tree there at the one call site
// and advances the lane. A warp ends when the queue is empty and its
// lanes are idle. So a warp idles only once the queue is empty, no block
// waits for its slowest warp, and what no design can shorten is left:
// the longest ray's own serial march.
//
// Why the shading and a ray's set-up go 32 at a time: a ray's direction
// (five IEEE divisions and a square root) and its colour (three powf)
// cost a turn or more each, and done one lane at a time, as lanes free
// up, they stall the whole warp once a ray. So each lane of the warp sets
// up one ray of a new batch into the warp's stage in shared memory
// (WarpStage), and the stacked rays are shaded 32 at once. Measured on
// the card (PERF.md §6): per-lane set-up and shading made the kernel
// slower than one ray a thread on every part; the shading phase as each
// lane's own (q per lane) and waiting for 4 idle lanes before a refill
// gave the times of this design within 1%.
//
// Each ray makes the evaluations it makes in the plain version, its march
// steps and then 5, in the same arithmetic: the image and the counts are
// the plain version's bit for bit.
//
// width, height, steps, relax, aa and the camera are launch arguments:
// one library serves a tree at every frame size, step count and aa (the
// JAX package compiles one executable per (tree, w, h, steps, relax, aa)).
// The camera (20 floats) goes by value as a __grid_constant__ struct: no
// upload. A frame is a 4-byte memset of the queue's counter and one
// launch; at aa > 1 a second launch, the box filter.
//
// The parametric form, K8p (gsdf_params.cuh): the same kernel around a
// parametric gsdf_tree(), which reads the tree's continuous parameters
// from the kernel's last argument, one library per tree structure: the
// viewer's slider edits re-render with no build. Counterpart of
// `_raymarch_fn(parametric=True)` (raymarch.py:150-169).
//
// The counting form (raymarch_sites.cu, GSDF_RM_COUNT_SITES): the same
// kernel, with each short-circuit site of the tree's code (a Difference
// that returns its minuend before it evaluates a subtrahend that cannot
// change the result, codegen/cuda.py) counted: per site, the lane
// evaluations that reached it, of them those that skipped, the warp turns
// in which a lane reached it, and of them those in which every lane that
// reached it skipped (the turns whose warp ran no subtrahend there); and
// per bin-table loop of a threshold form (GSDF_LOOP) the lane evaluations
// that entered it, the members they walked, the warp turns in which a lane
// entered it, and the members those turns walked (each turn's longest
// walk, which the warp runs); and per polygon's edge loop (GSDF_EDGES) the
// lane edge evaluations, of them those that divided, the warp edge turns
// (each group of lanes that runs the loop together takes one turn an
// edge), and of them those in which a lane divided: a warp's counts go to
// shared memory once a loop and to the output once at its end. A library
// of its own behind `eval/ray_kernels.py::count_short_circuits`; this
// form, which `raymarch` runs with or without evals, carries none of it.
//
// gsdf_tree.cuh is generated per tree by gsdf_tpu_torch/codegen/cuda.py.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#ifdef GSDF_RM_COUNT_SITES
static __device__ __forceinline__ bool gsdf_site_note(int site, bool skip);
#define GSDF_SITE(site, skip) gsdf_site_note(site, skip)
static __device__ __forceinline__ void gsdf_loop_note(int loop, int walked);
#define GSDF_LOOP(loop, n) gsdf_loop_note(loop, n)
// One run of a polygon's edge loop: the lanes that run it together, the
// edges at which this lane divided, and those at which any of them did.
struct GsdfEdges {
    unsigned lanes;
    int divided = 0, warp_divided = 0;
    __device__ __forceinline__ GsdfEdges() : lanes(__activemask()) {}
    __device__ __forceinline__ bool edge(bool divide) {
        divided += divide;
        warp_divided += __any_sync(lanes, divide);
        return divide;
    }
};
static __device__ __forceinline__ void gsdf_edges_note(int polygon, int n, const GsdfEdges& e);
#define GSDF_EDGES(k) GsdfEdges gsdf_edges
#define GSDF_EDGE(k, divide) gsdf_edges.edge(divide)
#define GSDF_EDGES_DONE(k, n) gsdf_edges_note(k, n, gsdf_edges)
#define GSDF_RM_SITES_DECL , unsigned long long* __restrict__ sites
#define GSDF_RM_SITES_ARG , sites
#else
#define GSDF_RM_SITES_DECL
#define GSDF_RM_SITES_ARG
#endif

#include "gsdf_tree.cuh"
#include "gsdf_params.cuh"
#include "gsdf_raymarch.cuh"
#ifndef GSDF_NSITES
#define GSDF_NSITES 0
#endif
#ifndef GSDF_NLOOPS
#define GSDF_NLOOPS 0
#endif
#ifndef GSDF_NPOLYGONS
#define GSDF_NPOLYGONS 0
#endif

namespace {

constexpr int kThreads = 128;  // four warps a block, each on its own
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBX = 16, kBY = 8;  // the box filter's blocks
constexpr int kMaxDevices = 64;

#ifdef GSDF_RM_COUNT_SITES
static_assert(GSDF_NSITES + GSDF_NPOLYGONS > 0,
              "the counting form is built for trees with short-circuit sites or polygons");

constexpr int kSites = GSDF_NSITES > 0 ? GSDF_NSITES : 1;
constexpr int kLoops = GSDF_NLOOPS > 0 ? GSDF_NLOOPS : 1;
constexpr int kPolygons = GSDF_NPOLYGONS > 0 ? GSDF_NPOLYGONS : 1;

// Each thread's visits ([0]) and skips ([1]) of each site in the current
// tree evaluation, as gsdf_site_note counts them; and its entries ([0])
// and members walked ([1]) of each loop, as gsdf_loop_note counts them.
__shared__ uint32_t site_hits[kSites][2][kThreads];
__shared__ uint32_t loop_hits[kLoops][2][kThreads];
// Each warp's counts of each polygon's edge loop, as gsdf_edges_note adds
// them: [0] lane edge evaluations, [1] of them divided, [2] warp edge
// turns, [3] of them with a lane that divided.
__shared__ unsigned long long edge_counts[kWarps][kPolygons][4];

// A thread's tally over its warp's turns: per site [0] lane evaluations
// that reached it, [1] of them skipped; lane 0 also [2] warp turns in
// which a lane reached it, [3] of them with every such lane skipping. Per
// loop [0] lane evaluations that entered it, [1] the members they walked;
// lane 0 also [2] warp turns in which a lane entered it, [3] the members
// the warp walked in them (each turn's longest walk).
struct SiteTally {
    unsigned long long n[kSites][4];
    unsigned long long m[kLoops][4];

    __device__ void start(int lane) {
        if (lane == 0)
            for (int k = 0; k < GSDF_NPOLYGONS; ++k)
                for (int j = 0; j < 4; ++j) edge_counts[threadIdx.x / 32][k][j] = 0;
        __syncwarp();
#pragma unroll
        for (int k = 0; k < GSDF_NSITES; ++k) {
            site_hits[k][0][threadIdx.x] = site_hits[k][1][threadIdx.x] = 0;
            n[k][0] = n[k][1] = n[k][2] = n[k][3] = 0;
        }
#pragma unroll
        for (int k = 0; k < kLoops; ++k) {
            loop_hits[k][0][threadIdx.x] = loop_hits[k][1][threadIdx.x] = 0;
            m[k][0] = m[k][1] = m[k][2] = m[k][3] = 0;
        }
    }

    // After a turn's evaluation, with every lane of the warp here.
    __device__ void turn(int lane) {
#pragma unroll
        for (int k = 0; k < GSDF_NSITES; ++k) {
            const uint32_t seen = site_hits[k][0][threadIdx.x];
            const uint32_t skipped = site_hits[k][1][threadIdx.x];
            site_hits[k][0][threadIdx.x] = site_hits[k][1][threadIdx.x] = 0;
            n[k][0] += seen;
            n[k][1] += skipped;
            const bool reached = __any_sync(kAll, seen != 0);
            const bool all = __all_sync(kAll, skipped == seen);
            if (lane == 0) {
                n[k][2] += reached;
                n[k][3] += reached && all;
            }
        }
#pragma unroll
        for (int k = 0; k < GSDF_NLOOPS; ++k) {
            const uint32_t entered = loop_hits[k][0][threadIdx.x];
            const uint32_t walked = loop_hits[k][1][threadIdx.x];
            loop_hits[k][0][threadIdx.x] = loop_hits[k][1][threadIdx.x] = 0;
            m[k][0] += entered;
            m[k][1] += walked;
            const bool reached = __any_sync(kAll, entered != 0);
            const uint32_t longest = __reduce_max_sync(kAll, walked);
            if (lane == 0) {
                m[k][2] += reached;
                m[k][3] += longest;
            }
        }
    }

    // The warp's sums into sites ((GSDF_NSITES + GSDF_NLOOPS +
    // GSDF_NPOLYGONS) x 4: the sites', the loops', then the polygons'), once
    // per warp.
    __device__ void flush(unsigned long long* sites, int lane) {
#pragma unroll
        for (int k = 0; k < GSDF_NSITES; ++k) {
            for (int j = 0; j < 2; ++j)
                for (int o = 16; o > 0; o /= 2) n[k][j] += __shfl_down_sync(kAll, n[k][j], o);
            if (lane == 0)
                for (int j = 0; j < 4; ++j) atomicAdd(&sites[4 * k + j], n[k][j]);
        }
#pragma unroll
        for (int k = 0; k < GSDF_NLOOPS; ++k) {
            for (int j = 0; j < 2; ++j)
                for (int o = 16; o > 0; o /= 2) m[k][j] += __shfl_down_sync(kAll, m[k][j], o);
            if (lane == 0)
                for (int j = 0; j < 4; ++j) atomicAdd(&sites[4 * (GSDF_NSITES + k) + j], m[k][j]);
        }
        __syncwarp();
        if (lane == 0)
            for (int k = 0; k < GSDF_NPOLYGONS; ++k)
                for (int j = 0; j < 4; ++j)
                    atomicAdd(&sites[4 * (GSDF_NSITES + GSDF_NLOOPS + k) + j],
                              edge_counts[threadIdx.x / 32][k][j]);
    }
};
#endif

// One warp's rays on their way in (the next batch, set up) and between
// march and shading (at most 31 left over and 32 more at a refill), as
// structures of arrays, so that 32 lanes on 32 entries hit 32 banks.
struct WarpStage {
    float next_rd[3][32];
    int next_at[32];  // the ray's frame index, -1 past the frame's edge
    float rd[3][64], t[64];
    int at[64], evals[64];
};

__global__ void __launch_bounds__(kThreads)
raymarch_kernel(uint8_t* __restrict__ samples, int* __restrict__ evals, int* __restrict__ queue,
                int rw, int rh, int n_ids, int steps, float relax,
                const __grid_constant__ gsdf_rm::Camera cam GSDF_PARAMS_DECL GSDF_RM_SITES_DECL) {
    __shared__ WarpStage stage[kWarps];
    WarpStage& w = stage[threadIdx.x / 32];
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    auto scene = [&](float x, float y, float z) { return GSDF_TREE(x, y, z); };
    gsdf_rm::Lane ray = {};
    bool busy = false, marched = false;  // marching; holding a ray whose march is over
    // the lane's ray in a shading round: its hit point, direction, final
    // distance, normal sum, frame index and count (live: the lane has one)
    float pos[3] = {}, srd[3] = {}, d0 = 0.0f, n[3] = {};
    int s_at = 0, s_evals = 0;
    bool s_live = false;
    // warp-uniform: busy lanes, rays of the batch handed out, marched rays
    // on the stack, the shading round's evaluation (-1: march turns), and
    // whether the queue has run out
    int n_busy = 0, taken = 32, n_marched = 0, q = -1;
    bool drained = false;
#ifdef GSDF_RM_COUNT_SITES
    SiteTally tally;
    tally.start(lane);
#endif
#pragma unroll 1
    for (;;) {
        if (q < 0 && (n_busy == 0 || (!drained && n_busy < 32))) {
            // the lanes' marched rays onto the stack
            const unsigned held = __ballot_sync(kAll, marched);
            if (marched) {
                const int i = n_marched + __popc(held & below);
                for (int a = 0; a < 3; ++a) w.rd[a][i] = ray.rd[a];
                w.t[i] = ray.t;
                w.at[i] = ray.at;
                w.evals[i] = ray.steps + 5;
                marched = false;
            }
            n_marched += __popc(held);
            if (!drained) {  // rays for the idle lanes, in lane order
                const unsigned idle = __ballot_sync(kAll, !busy);
                const int k = __popc(idle), rank = __popc(idle & below), left = 32 - taken;
                int slot = !busy && rank < left ? taken + rank : -1;
                if (k <= left) {
                    taken += k;
                } else {  // a new batch for the lanes the old one did not serve
                    int base = 0;
                    if (lane == 0) base = atomicAdd(queue, 32);
                    base = __shfl_sync(kAll, base, 0);
                    if (base >= n_ids) {
                        drained = true;
                    } else {
                        int ix, iy;
                        float rd[3] = {0.0f, 0.0f, 0.0f};
                        const bool real = gsdf_rm::queue_ray(base + lane, rw, rh, &ix, &iy);
                        if (real) gsdf_rm::ray_dir(cam, ix, iy, rw, rh, rd);
                        if (slot >= 0) {  // the old batch's ray, read before the new is written
                            const float old[3] = {w.next_rd[0][slot], w.next_rd[1][slot],
                                                  w.next_rd[2][slot]};
                            const int at = w.next_at[slot];
                            if (at >= 0) {
                                gsdf_rm::lane_start(ray, old, at);
                                busy = steps > 0;
                                marched = steps == 0;
                            }
                            slot = -1;
                        }
                        __syncwarp();
                        for (int a = 0; a < 3; ++a) w.next_rd[a][lane] = rd[a];
                        w.next_at[lane] = real ? iy * rw + ix : -1;
                        __syncwarp();
                        if (!busy && !marched && rank >= left) slot = rank - left;
                        taken = k - left;
                    }
                }
                if (slot >= 0 && w.next_at[slot] >= 0) {
                    const float rd[3] = {w.next_rd[0][slot], w.next_rd[1][slot],
                                         w.next_rd[2][slot]};
                    gsdf_rm::lane_start(ray, rd, w.next_at[slot]);
                    busy = steps > 0;
                    marched = steps == 0;  // no march step: straight to shading
                }
            }
            n_busy = __popc(__ballot_sync(kAll, busy));
            if (n_marched >= 32 || (n_busy == 0 && drained && n_marched > 0)) {
                // a shading round on the stack's top 32 (or all that is left)
                const int rest = n_marched > 32 ? n_marched - 32 : 0, i = rest + lane;
                __syncwarp();
                s_live = i < n_marched;
                if (s_live) {
                    for (int a = 0; a < 3; ++a) {
                        srd[a] = w.rd[a][i];
                        pos[a] = cam.ro[a] + srd[a] * w.t[i];
                    }
                    s_at = w.at[i];
                    s_evals = w.evals[i];
                }
                __syncwarp();
                n_marched = rest;
                q = 0;
            } else if (n_busy == 0) {
                if (drained && !__any_sync(kAll, marched)) break;
                continue;  // no lane marches: refill again (or push the rays held)
            }
        }
        float p[3];
        bool live;
        if (q >= 0) {
            gsdf_rm::shade_point(pos, q, p);
            live = s_live;
        } else {
            gsdf_rm::march_point(ray, cam, p);
            live = busy;
        }
        float d = 0.0f;
        if (live) d = gsdf_rm::scene_at(scene, cam, p);  // the one call site
#ifdef GSDF_RM_COUNT_SITES
        tally.turn(lane);
#endif
        if (q >= 0) {
            gsdf_rm::shade_step(q, d, &d0, n);
            if (++q == 5) {
                if (s_live) {
                    uint8_t rgb[3];
                    gsdf_rm::shade(cam, srd, n, d0, rgb);
                    samples[3 * (int64_t)s_at] = rgb[0];
                    samples[3 * (int64_t)s_at + 1] = rgb[1];
                    samples[3 * (int64_t)s_at + 2] = rgb[2];
                    if (evals != nullptr) evals[s_at] = s_evals;
                }
                q = -1;
            }
        } else {
            bool over = false;
            if (busy) over = gsdf_rm::march_step(ray, cam, d, steps, relax);
            marched = marched || over;
            busy = busy && !over;
            n_busy -= __popc(__ballot_sync(kAll, over));
        }
    }
#ifdef GSDF_RM_COUNT_SITES
    tally.flush(sites, lane);
#endif
}

__global__ void __launch_bounds__(kBX * kBY)
box_filter_kernel(const uint8_t* __restrict__ samples, uint8_t* __restrict__ out, int width,
                  int height, int aa) {
    const int x = blockIdx.x * kBX + threadIdx.x;
    const int y = blockIdx.y * kBY + threadIdx.y;
    if (x >= width || y >= height) return;
    gsdf_rm::box_filter(samples, out, x, y, width, aa);
}

// The blocks of raymarch_kernel the current device holds at once (SMs x
// resident blocks), asked once per device and kept: no call of this
// synchronises, and the launch after the first asks nothing.
int resident_blocks(int* blocks) {
    static std::atomic<int> known[kMaxDevices];
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc != 0) return rc;
    if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    *blocks = known[dev].load(std::memory_order_relaxed);
    if (*blocks > 0) return 0;
    int sms = 0, per_sm = 0;
    rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == 0)
        rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raymarch_kernel, kThreads,
                                                                0);
    if (rc != 0) return rc;
    if (sms < 1 || per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *blocks = sms * per_sm;
    known[dev].store(*blocks, std::memory_order_relaxed);
    return 0;
}

}  // namespace

#ifdef GSDF_RM_COUNT_SITES
static __device__ __forceinline__ bool gsdf_site_note(int site, bool skip) {
    site_hits[site][0][threadIdx.x] += 1u;
    site_hits[site][1][threadIdx.x] += skip;
    return skip;
}

static __device__ __forceinline__ void gsdf_loop_note(int loop, int walked) {
    loop_hits[loop][0][threadIdx.x] += 1u;
    loop_hits[loop][1][threadIdx.x] += (uint32_t)walked;
}

// The lowest lane of those that ran the loop adds their counts: shared
// atomics, since two groups of one warp's lanes may run it apart.
static __device__ __forceinline__ void gsdf_edges_note(int polygon, int n, const GsdfEdges& e) {
    const unsigned divided = __reduce_add_sync(e.lanes, (unsigned)e.divided);
    if ((int)(threadIdx.x & 31) == __ffs(e.lanes) - 1) {
        unsigned long long* c = edge_counts[threadIdx.x / 32][polygon];
        atomicAdd(&c[0], (unsigned long long)n * __popc(e.lanes));
        atomicAdd(&c[1], (unsigned long long)divided);
        atomicAdd(&c[2], (unsigned long long)n);
        atomicAdd(&c[3], (unsigned long long)e.warp_divided);
    }
}
#endif

// samples (aa*height, aa*width, 3) u8; out (height, width, 3) u8, the
// samples themselves where aa == 1; evals (aa*height, aa*width) int32
// tree evaluations per supersample, or null; queue one int32 of device
// memory, the ray queue's counter, set to 0 here; cam the 20 floats of
// gsdf_rm::Camera (a host pointer). Enqueues on `stream` the memset, the
// kernel and, at aa > 1, the box filter; returns the first CUDA error (0
// = launched). The parametric entry point also takes the parameter vector
// (a host pointer where it goes by value, else a device pointer) and its
// length, which must be the structure's. The counting entry point also
// takes `sites`, (GSDF_NSITES + GSDF_NLOOPS + GSDF_NPOLYGONS) x 4 uint64 of
// device memory set here to the counts of the kernel's note above.
#if defined(GSDF_RM_COUNT_SITES)
extern "C" int gsdf_raymarch_sites(uint8_t* samples, uint8_t* out, int* evals, int* queue,
                                   const float* cam, int width, int height, int steps,
                                   float relax, int aa, unsigned long long* sites,
                                   void* stream) {
    if (sites == nullptr) return (int)cudaErrorInvalidValue;
#elif defined(GSDF_PARAMETRIC)
extern "C" int gsdf_raymarch_param(uint8_t* samples, uint8_t* out, int* evals, int* queue,
                                   const float* cam, int width, int height, int steps,
                                   float relax, int aa, const float* params, int n_params,
                                   void* stream) {
    if (params == nullptr || n_params != GSDF_NPARAMS) return (int)cudaErrorInvalidValue;
#if GSDF_PARAMS_BY_VALUE
    GsdfParams gsdf_params;
    memcpy(gsdf_params.v, params, sizeof gsdf_params.v);
#else
    const float* gsdf_params = params;
#endif
#else
extern "C" int gsdf_raymarch(uint8_t* samples, uint8_t* out, int* evals, int* queue,
                             const float* cam, int width, int height, int steps, float relax,
                             int aa, void* stream) {
#endif
    if (width < 1 || height < 1 || steps < 0 || aa < 1 || cam == nullptr || queue == nullptr ||
        (int64_t)width * aa > (1 << 20) || (int64_t)height * aa > (1 << 20) ||
        height > 65535 * kBY || gsdf_rm::queue_length(width * aa, height * aa) > (1 << 30) ||
        (aa == 1) != (samples == out))  // ids, their counter and frame indices fit an int
        return (int)cudaErrorInvalidValue;
    gsdf_rm::Camera c;
    memcpy(&c, cam, sizeof c);
    const int rw = width * aa, rh = height * aa;
    const int64_t n_ids = gsdf_rm::queue_length(rw, rh);
    int blocks = 0;
    int rc = resident_blocks(&blocks);
    if (rc != 0) return rc;
    if ((int64_t)blocks * kThreads > n_ids) blocks = (int)((n_ids + kThreads - 1) / kThreads);
    const cudaStream_t s = (cudaStream_t)stream;
    rc = (int)cudaMemsetAsync(queue, 0, sizeof(int), s);
    if (rc != 0) return rc;
#ifdef GSDF_RM_COUNT_SITES
    rc = (int)cudaMemsetAsync(
        sites, 0, (GSDF_NSITES + GSDF_NLOOPS + GSDF_NPOLYGONS) * 4 * sizeof(unsigned long long), s);
    if (rc != 0) return rc;
#endif
    raymarch_kernel<<<blocks, kThreads, 0, s>>>(samples, evals, queue, rw, rh, (int)n_ids, steps,
                                                relax, c GSDF_PARAMS_ARG GSDF_RM_SITES_ARG);
    if (aa > 1) {
        rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
        box_filter_kernel<<<dim3((width + kBX - 1) / kBX, (height + kBY - 1) / kBY),
                            dim3(kBX, kBY), 0, s>>>(samples, out, width, height, aa);
    }
    return (int)cudaGetLastError();
}
