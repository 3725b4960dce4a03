// Native runtime components: hot host-side paths of the render pipeline.
//
// The reference's only native surface is its cgo OpenGL binding
// (gleval/gpu_cgo.go); in this framework XLA owns device compute, and the
// native layer instead accelerates the host-side IO endpoints that remain
// on the critical path:
//   - binary STL encoding (normal computation + 50-byte record packing,
//     reference glrender/stl.go:15-62) — single pass, no intermediate
//     allocations, ~10x faster than the numpy structured-array path
//   - binary STL decoding with validation counters
//   - vertex welding (triangle soup -> indexed mesh) via an open-addressing
//     hash on quantized coordinates, enabling OBJ/PLY export and mesh
//     dedup the reference lacks
//
// Exposed with a plain C ABI for ctypes (no pybind11 dependency).
#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

// The ONE chunk-and-join thread pool every entry point shares: splits
// [0, n) into nthreads contiguous chunks and runs body(t, lo, hi) on
// each (t = chunk/thread id, for callers that keep per-thread state).
// nthreads <= 1 runs inline.
template <typename Body>
static void run_parallel(int nthreads, int64_t n, Body body) {
    if (nthreads <= 1) {
        body(0, (int64_t)0, n);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min<int64_t>(lo + chunk, n);
        if (lo >= hi) break;
        ts.emplace_back(body, t, lo, hi);
    }
    for (auto& th : ts) th.join();
}

extern "C" {

// Encode n triangles (n*9 floats, v0 v1 v2 per triangle) into binary STL
// records at out (n*50 bytes). The 84-byte header is the caller's job.
void gsdf_stl_encode(const float* tris, int64_t n, unsigned char* out) {
    for (int64_t i = 0; i < n; i++) {
        const float* t = tris + i * 9;
        float e1x = t[3] - t[0], e1y = t[4] - t[1], e1z = t[5] - t[2];
        float e2x = t[6] - t[0], e2y = t[7] - t[1], e2z = t[8] - t[2];
        float nx = e1y * e2z - e1z * e2y;
        float ny = e1z * e2x - e1x * e2z;
        float nz = e1x * e2y - e1y * e2x;
        float len = std::sqrt(nx * nx + ny * ny + nz * nz);
        if (len > 0) {
            nx /= len;
            ny /= len;
            nz /= len;
        }
        unsigned char* rec = out + i * 50;
        float hdr[3] = {nx, ny, nz};
        std::memcpy(rec, hdr, 12);
        std::memcpy(rec + 12, t, 36);
        rec[48] = 0;
        rec[49] = 0;
    }
}

// Decode n STL records into n*9 floats. Returns number of non-finite
// vertices encountered (0 = clean).
int64_t gsdf_stl_decode(const unsigned char* recs, int64_t n, float* tris) {
    int64_t bad = 0;
    for (int64_t i = 0; i < n; i++) {
        const unsigned char* rec = recs + i * 50;
        float* t = tris + i * 9;
        std::memcpy(t, rec + 12, 36);
        for (int k = 0; k < 9; k++) {
            if (!std::isfinite(t[k])) bad++;
        }
    }
    return bad;
}

// Weld triangle soup into an indexed mesh. Vertices equal after
// quantization by `tol` are merged. Outputs:
//   verts_out: up to n*3 unique vertices (x,y,z each)
//   idx_out:   n*3 int32 indices
// Returns the number of unique vertices.
int64_t gsdf_weld(const float* tris, int64_t n, float tol, float* verts_out,
                  int32_t* idx_out) {
    const int64_t nv = n * 3;
    // open addressing hash table, power-of-two size >= 2*nv
    int64_t cap = 16;
    while (cap < nv * 2) cap <<= 1;
    std::vector<int64_t> table(cap, -1);
    const float inv = tol > 0 ? 1.0f / tol : 1e12f;
    int64_t unique = 0;
    for (int64_t v = 0; v < nv; v++) {
        const float* p = tris + v * 3;
        int64_t qx = (int64_t)std::llround((double)p[0] * inv);
        int64_t qy = (int64_t)std::llround((double)p[1] * inv);
        int64_t qz = (int64_t)std::llround((double)p[2] * inv);
        uint64_t h = (uint64_t)qx * 0x9E3779B185EBCA87ULL ^
                     (uint64_t)qy * 0xC2B2AE3D27D4EB4FULL ^
                     (uint64_t)qz * 0x165667B19E3779F9ULL;
        h ^= h >> 29;
        int64_t slot = (int64_t)(h & (uint64_t)(cap - 1));
        int64_t found = -1;
        while (true) {
            int64_t entry = table[slot];
            if (entry < 0) break;
            const float* q = verts_out + entry * 3;
            int64_t ex = (int64_t)std::llround((double)q[0] * inv);
            int64_t ey = (int64_t)std::llround((double)q[1] * inv);
            int64_t ez = (int64_t)std::llround((double)q[2] * inv);
            if (ex == qx && ey == qy && ez == qz) {
                found = entry;
                break;
            }
            slot = (slot + 1) & (cap - 1);
        }
        if (found < 0) {
            found = unique++;
            float* dst = verts_out + found * 3;
            dst[0] = p[0];
            dst[1] = p[1];
            dst[2] = p[2];
            table[slot] = found;
        }
        idx_out[v] = (int32_t)found;
    }
    return unique;
}

// Marching-cubes table walk for the compact-field render path
// (ops/compact_field.py). The device ships only active cube ids, case
// bytes and per-crossing-edge interpolation parameters; this reconstructs
// the indexed mesh with the same float32 arithmetic as the device — the
// host-side table walk the reference also performs
// (glrender/marchcubes.go:34 consumed after GPU evaluation).
//
// Tables are passed in from Python (ops/mc_tables.py) so the 256-case
// data lives in exactly one place:
//   tri_table: 256*5*3 int8 edge ids (-1 padded)
//   tri_count: 256 uint8
//   edge_axis: 12 uint8 (0=x,1=y,2=z of each cube edge)
//   edge_low:  12*3 int8 (owner-cube offset of each cube edge)
//
// Returns the number of triangles written, or -1 if an owner-cube
// reference could not be resolved (non-Lipschitz field pruned an owner;
// caller falls back to the device welded path).
int64_t gsdf_mc_decode(const uint32_t* ids, const uint8_t* cases,
                       int64_t n_active, const float* tvals, int64_t n_verts,
                       int32_t nx, int32_t ny, int32_t nz,
                       const float* origin, float res,
                       const int8_t* tri_table, const uint8_t* tri_count,
                       const uint8_t* edge_axis, const int8_t* edge_low,
                       float* verts_out, int32_t* tri_idx_out) {
    const int64_t ncubes = (int64_t)nx * ny * nz;
    // Slot map over the FULL cube grid, 1-based (0 = inactive). A plain
    // per-call fill costs the whole map in writes/page faults every
    // decode (408 MB at a 102M-cube slabbed render), so:
    // - steady state reuses a process-cached grow-only buffer and,
    //   after use, re-zeroes ONLY the n_active touched entries (the
    //   clean-buffer invariant every acquisition relies on); capped at
    //   2^24 cubes so the retained buffer never exceeds 64 MB;
    // - bigger grids and concurrent callers take a fresh calloc
    //   instead — lazily-faulted zero pages, only surface pages ever
    //   touched.
    static std::mutex slot_mu;
    static int32_t* slot_cache = nullptr;
    static int64_t slot_cap = 0;
    int32_t* slot = nullptr;
    bool cached = false;
    std::unique_lock<std::mutex> slot_lk(slot_mu, std::try_to_lock);
    if (ncubes <= ((int64_t)1 << 24) && slot_lk.owns_lock()) {
        if (slot_cap < ncubes) {
            std::free(slot_cache);
            slot_cache = (int32_t*)std::calloc((size_t)ncubes,
                                               sizeof(int32_t));
            slot_cap = slot_cache ? ncubes : 0;
        }
        if (slot_cache) {
            slot = slot_cache;
            cached = true;
        }
    }
    if (!cached) slot = (int32_t*)std::calloc((size_t)ncubes, sizeof(int32_t));
    if (!slot) return -1;
    auto release_slot = [&]() {
        if (cached) {
            // restore the clean-buffer invariant: zero exactly the
            // entries pass 1 may have written (out-of-range ids were
            // never written; zeroing an unwritten entry is a no-op)
            for (int64_t a = 0; a < n_active; a++)
                if ((int64_t)ids[a] < ncubes) slot[ids[a]] = 0;
        } else {
            std::free(slot);
        }
    };
    std::vector<int32_t> vbase(n_active + 1, 0);
    std::vector<int64_t> toffs(n_active + 1, 0);

    const int nthreads = (int)std::min<int64_t>(
        std::max(1u, std::thread::hardware_concurrency()),
        std::max<int64_t>(1, n_active / 16384));
    std::atomic<bool> failed(false);

    auto parallel_for = [&](auto body) {
        run_parallel(nthreads, n_active,
                     [&](int, int64_t lo, int64_t hi) { body(lo, hi); });
    };

    // pass 1 (parallel): slot map (disjoint writes), per-cube vertex and
    // triangle counts. ids are caller data: an id past the decode space
    // (e.g. a sharded render whose padded halo layer went active on a
    // non-Lipschitz field) must fail cleanly, not write out of bounds.
    parallel_for([&](int64_t lo, int64_t hi) {
        for (int64_t a = lo; a < hi; a++) {
            if ((int64_t)ids[a] >= ncubes) {
                failed.store(true, std::memory_order_relaxed);
                return;
            }
            const uint32_t c = cases[a];
            slot[ids[a]] = (int32_t)(a + 1);  // 1-based; 0 = inactive
            const uint32_t b0 = c & 1u;
            vbase[a + 1] = (int32_t)((b0 ^ ((c >> 1) & 1u)) +
                                     (b0 ^ ((c >> 3) & 1u)) +
                                     (b0 ^ ((c >> 4) & 1u)));
            toffs[a + 1] = tri_count[c];
        }
    });

    if (failed.load()) {
        release_slot();
        return -1;  // out-of-range cube id
    }

    // prefix sums (serial, O(n_active))
    for (int64_t a = 0; a < n_active; a++) {
        vbase[a + 1] = (int32_t)(vbase[a + 1] + vbase[a]);
        toffs[a + 1] += toffs[a];
    }
    if ((int64_t)vbase[n_active] != n_verts) {
        release_slot();
        return -1;  // corrupt payload
    }

    // pass 2 (parallel): vertex reconstruction + triangle table walk,
    // every cube writes disjoint [vbase[a], vbase[a+1]) / toffs ranges
    parallel_for([&](int64_t lo, int64_t hi) {
        for (int64_t a = lo; a < hi && !failed.load(std::memory_order_relaxed);
             a++) {
            const uint32_t id = ids[a];
            const uint32_t c = cases[a];
            const int32_t ci = (int32_t)(id % (uint32_t)nx);
            const int32_t cj = (int32_t)((id / (uint32_t)nx) % (uint32_t)ny);
            const int32_t ck = (int32_t)(id / ((uint32_t)nx * (uint32_t)ny));
            // reference float32 arithmetic: origin + index*res, +res/axis
            const float pa[3] = {origin[0] + (float)ci * res,
                                 origin[1] + (float)cj * res,
                                 origin[2] + (float)ck * res};
            const uint32_t b0 = c & 1u;
            const uint32_t cross[3] = {b0 ^ ((c >> 1) & 1u),
                                       b0 ^ ((c >> 3) & 1u),
                                       b0 ^ ((c >> 4) & 1u)};
            int64_t vc = vbase[a];
            for (int ax = 0; ax < 3; ax++) {
                if (!cross[ax]) continue;
                const float t = tvals[vc];
                float* o = verts_out + vc * 3;
                o[0] = pa[0];
                o[1] = pa[1];
                o[2] = pa[2];
                const float pb = pa[ax] + res;
                o[ax] = (t == 1.0f) ? pb : pa[ax] + t * (pb - pa[ax]);
                vc++;
            }

            const int nt = tri_count[c];
            const int8_t* row = tri_table + (int64_t)c * 15;
            int64_t tc = toffs[a];
            for (int sidx = 0; sidx < nt; sidx++) {
                int32_t vid[3];
                for (int j = 0; j < 3; j++) {
                    const int e = row[sidx * 3 + j];
                    const int ax = edge_axis[e];
                    const int32_t oi = ci + edge_low[e * 3 + 0];
                    const int32_t oj = cj + edge_low[e * 3 + 1];
                    const int32_t ok = ck + edge_low[e * 3 + 2];
                    if (oi >= nx || oj >= ny || ok >= nz) {
                        failed.store(true, std::memory_order_relaxed);
                        return;
                    }
                    const int64_t olin = ((int64_t)ok * ny + oj) * nx + oi;
                    const int32_t os = slot[olin] - 1;
                    if (os < 0) {  // owner not active
                        failed.store(true, std::memory_order_relaxed);
                        return;
                    }
                    const uint32_t oc = cases[os];
                    const uint32_t ob0 = oc & 1u;
                    const uint32_t ocx = ob0 ^ ((oc >> 1) & 1u);
                    const uint32_t ocy = ob0 ^ ((oc >> 3) & 1u);
                    int rank = 0;
                    if (ax == 1)
                        rank = (int)ocx;
                    else if (ax == 2)
                        rank = (int)(ocx + ocy);
                    vid[j] = vbase[os] + rank;
                }
                // winding: Triangle{points[t2], points[t1], points[t0]}
                int32_t* out = tri_idx_out + tc * 3;
                out[0] = vid[2];
                out[1] = vid[1];
                out[2] = vid[0];
                tc++;
            }
        }
    });
    release_slot();
    if (failed.load()) return -1;
    return toffs[n_active];
}

// Encode an indexed mesh directly into binary STL records (gather +
// normal + pack in one pass; skips materializing the 36 B/triangle soup).
void gsdf_stl_encode_indexed(const float* verts, const int32_t* tri_idx,
                             int64_t n, unsigned char* out) {
    const int nthreads = (int)std::min<int64_t>(
        std::max(1u, std::thread::hardware_concurrency()),
        std::max<int64_t>(1, n / 65536));
    run_parallel(nthreads, n, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
        const int32_t* ix = tri_idx + i * 3;
        const float* a = verts + (int64_t)ix[0] * 3;
        const float* b = verts + (int64_t)ix[1] * 3;
        const float* c = verts + (int64_t)ix[2] * 3;
        float e1x = b[0] - a[0], e1y = b[1] - a[1], e1z = b[2] - a[2];
        float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
        float nxv = e1y * e2z - e1z * e2y;
        float nyv = e1z * e2x - e1x * e2z;
        float nzv = e1x * e2y - e1y * e2x;
        float len = std::sqrt(nxv * nxv + nyv * nyv + nzv * nzv);
        if (len > 0) {
            nxv /= len;
            nyv /= len;
            nzv /= len;
        }
        unsigned char* rec = out + i * 50;
        float hdr[3] = {nxv, nyv, nzv};
        std::memcpy(rec, hdr, 12);
        std::memcpy(rec + 12, a, 12);
        std::memcpy(rec + 24, b, 12);
        std::memcpy(rec + 36, c, 12);
            rec[48] = 0;
            rec[49] = 0;
        }
    });
}

// Dual-contour host finish: quad emission from the v2 mesh payload
// (render/dual_contour.py::finish_dc_mesh is the numpy oracle this must
// match BIT-FOR-BIT — same derived voxel table, same triangle order).
//
// Inputs are the unpacked per-edge arrays: eax (axis 0..2), lin (the
// edge's origin-voxel linear id in the (nx,ny,nz) voxel space — GLOBAL
// for the sharded path, hence int64), flips, and the kernel vertex
// slots (kernel order, >= n_vox rows used). offs is the (3,4,3)
// quad-corner offset table passed from the single Python source
// (render/dual_contour._OFFS). Output layout: for each axis a with
// m[a] fully-in-range quads, a block of m[a] [c0,c1,c2] triangles then
// a block of m[a] [c2,c3,c0] triangles (flipped quads reverse corner
// order), axes concatenated — exactly the numpy path's per-axis
// two-block emission. blocks_out[6] gets {m0,m0,m1,m1,m2,m2}.
// Returns the triangle count; -(derived_voxel_count)-1 when the
// derived unique voxel table disagrees with n_vox; INT64_MIN when an
// edge's axis/lin is outside the grid (corrupt payload — the caller
// raises in both cases, never truncates).
// force_sort=1 selects the sorted-table backend regardless of grid
// size (the tests' lever for covering the huge-grid path).
int64_t gsdf_dc_finish(const float* verts, const int64_t* eax,
                       const int64_t* lin, const uint8_t* flips, int64_t n,
                       int32_t nx, int32_t ny, int32_t nz, int64_t n_vox,
                       const int32_t* offs, float* tris_out,
                       int64_t* blocks_out, int32_t force_sort) {
    const int64_t plane = (int64_t)ny * nx;
    const int nthreads = (int)std::min<int64_t>(
        std::max(1u, std::thread::hardware_concurrency()),
        std::max<int64_t>(1, n / 16384));

    auto parallel_for = [&](auto body) { run_parallel(nthreads, n, body); };
    // Rank structure for vid lookup (vid = ascending-unique rank of a
    // voxel id, == numpy searchsorted into the unique table). Two
    // interchangeable backends with identical ranks:
    // - bitmap + popcount prefix when the voxel space fits (<= 2^28
    //   bits = 32 MB): O(1) rank per corner, no sort — the fast path.
    // - sorted unique table + binary search for huge GLOBAL id spaces
    //   (sharded renders chunked past int32 can exceed the bitmap).
    const int64_t V = (int64_t)nz * plane;  // total voxel-id space
    const bool use_bitmap = !force_sort && V <= ((int64_t)1 << 28);
    std::vector<uint64_t> bits;
    std::vector<int64_t> pref;   // per-word exclusive popcount prefix
    std::vector<int64_t> uvox;   // sort-path unique table

    // pass 1: per-edge corner ids; mark/collect in-range corner + own
    // voxel ids, count fully-in-range quads per axis (slots indexed by
    // thread id; trailing ones may stay empty). eax/lin are caller data
    // (a decoded payload): out-of-range values must fail cleanly — the
    // gsdf_mc_decode discipline — never index past the bitmap/tables.
    std::atomic<bool> bad_edge(false);
    std::vector<std::vector<int64_t>> cand(use_bitmap ? 0 : nthreads);
    std::vector<std::array<int64_t, 3>> cnt(nthreads, {0, 0, 0});
    if (use_bitmap) bits.assign((size_t)((V + 63) / 64), 0);
    parallel_for([&](int t, int64_t lo, int64_t hi) {
        std::vector<int64_t>* cv = use_bitmap ? nullptr : &cand[t];
        if (cv) cv->reserve((hi - lo) * 5);
        auto mark = [&](int64_t id) {
            if (use_bitmap) {
                // relaxed atomic OR: threads may mark the same word
                __atomic_fetch_or(&bits[(size_t)(id >> 6)],
                                  (uint64_t)1 << (id & 63),
                                  __ATOMIC_RELAXED);
            } else {
                cv->push_back(id);
            }
        };
        for (int64_t e = lo; e < hi; e++) {
            const int64_t l = lin[e];
            if ((uint64_t)eax[e] > 2 || (uint64_t)l >= (uint64_t)V) {
                bad_edge.store(true, std::memory_order_relaxed);
                return;
            }
            const int64_t ek = l / plane;
            const int64_t ej = (l / nx) % ny;
            const int64_t ei = l % nx;
            const int32_t* o = offs + eax[e] * 12;
            bool ok = true;
            for (int c = 0; c < 4; c++) {
                const int64_t ii = ei + o[c * 3 + 0];
                const int64_t jj = ej + o[c * 3 + 1];
                const int64_t kk = ek + o[c * 3 + 2];
                if (ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 &&
                    kk < nz) {
                    mark((kk * ny + jj) * nx + ii);
                } else {
                    ok = false;
                }
            }
            mark(l);  // own voxel
            if (ok) cnt[t][eax[e]]++;
        }
    });

    if (bad_edge.load()) return INT64_MIN;  // corrupt payload edge
    int64_t derived = 0;
    if (use_bitmap) {
        pref.resize(bits.size() + 1);
        pref[0] = 0;
        for (size_t w = 0; w < bits.size(); w++)
            pref[w + 1] = pref[w] + __builtin_popcountll(bits[w]);
        derived = pref[bits.size()];
    } else {
        // unique ascending voxel table == the kernel's vertex-slot keys
        int64_t total = 0;
        for (auto& cv : cand) total += (int64_t)cv.size();
        uvox.reserve(total);
        for (auto& cv : cand) {
            uvox.insert(uvox.end(), cv.begin(), cv.end());
            cv.clear();
            cv.shrink_to_fit();
        }
        std::sort(uvox.begin(), uvox.end());
        uvox.erase(std::unique(uvox.begin(), uvox.end()), uvox.end());
        derived = (int64_t)uvox.size();
    }
    if (derived != n_vox) return -derived - 1;
    auto rank_of = [&](int64_t id) -> int64_t {
        if (use_bitmap) {
            const size_t w = (size_t)(id >> 6);
            const uint64_t below = bits[w] & (((uint64_t)1 << (id & 63)) - 1);
            return pref[w] + __builtin_popcountll(below);
        }
        return std::lower_bound(uvox.begin(), uvox.end(), id) - uvox.begin();
    };

    // block layout: axis a's first-triangle block starts at
    // 2*sum(m[<a]); per-chunk start ranks give each thread its exact
    // write slots (deterministic edge order within each block)
    int64_t m[3] = {0, 0, 0};
    for (int t = 0; t < nthreads; t++)
        for (int a = 0; a < 3; a++) m[a] += cnt[t][a];
    int64_t base[3];
    base[0] = 0;
    base[1] = 2 * m[0];
    base[2] = 2 * (m[0] + m[1]);
    // per-chunk exclusive prefix of quad counts per axis
    std::vector<std::array<int64_t, 3>> start(nthreads);
    {
        int64_t run[3] = {0, 0, 0};
        for (int t = 0; t < nthreads; t++) {
            for (int a = 0; a < 3; a++) {
                start[t][a] = run[a];
                run[a] += cnt[t][a];
            }
        }
    }
    for (int a = 0; a < 3; a++) {
        blocks_out[2 * a] = m[a];
        blocks_out[2 * a + 1] = m[a];
    }

    // pass 2: gather quad corners (rank_of == numpy searchsorted into
    // the ascending-unique voxel table) and write both triangle blocks
    parallel_for([&](int t, int64_t lo, int64_t hi) {
        int64_t rank[3] = {start[t][0], start[t][1], start[t][2]};
        for (int64_t e = lo; e < hi; e++) {
            const int64_t l = lin[e];
            const int64_t ek = l / plane;
            const int64_t ej = (l / nx) % ny;
            const int64_t ei = l % nx;
            const int a = (int)eax[e];
            const int32_t* o = offs + a * 12;
            int64_t vid[4];
            bool ok = true;
            for (int c = 0; c < 4; c++) {
                const int64_t ii = ei + o[c * 3 + 0];
                const int64_t jj = ej + o[c * 3 + 1];
                const int64_t kk = ek + o[c * 3 + 2];
                if (!(ii >= 0 && ii < nx && jj >= 0 && jj < ny && kk >= 0 &&
                      kk < nz)) {
                    ok = false;
                    break;
                }
                vid[c] = rank_of((kk * ny + jj) * nx + ii);
            }
            if (!ok) continue;
            const float* q[4];
            if (flips[e]) {
                for (int c = 0; c < 4; c++) q[c] = verts + vid[3 - c] * 3;
            } else {
                for (int c = 0; c < 4; c++) q[c] = verts + vid[c] * 3;
            }
            const int64_t r = rank[a]++;
            float* t1 = tris_out + (base[a] + r) * 9;
            float* t2 = tris_out + (base[a] + m[a] + r) * 9;
            std::memcpy(t1 + 0, q[0], 12);
            std::memcpy(t1 + 3, q[1], 12);
            std::memcpy(t1 + 6, q[2], 12);
            std::memcpy(t2 + 0, q[2], 12);
            std::memcpy(t2 + 3, q[3], 12);
            std::memcpy(t2 + 6, q[0], 12);
        }
    });
    return 2 * (m[0] + m[1] + m[2]);
}

}  // extern "C"
