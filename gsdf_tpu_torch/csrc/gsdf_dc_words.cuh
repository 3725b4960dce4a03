// Dual contouring's word-level index arithmetic, shared by K5 (dc_mesh.cu)
// and a g++ test on the CPU (tests/test_torch_dc_words.py), which holds it
// against the plain torch version (ops/dc_emit.py): plain C++ that nvcc
// builds for the card and g++ for the host.
//
// The edge space of a corner grid (nk, nj, ni) has nx * ny * layers
// voxels (nx = ni - 1, ny = nj - 1, layers = nk - 1), x fastest, and each
// voxel its x, y and z edge from its low corner. Each axis's active edges
// are a bitset over the voxel ids, 32 voxels a word.
//
// A voxel receives rows only from the edges at fixed offsets from it
// (ops/dc_tables.py GATHER): the edge of axis a at the voxel offset by 0
// on axis a and by 0 or 1 on each of the other two. Offset by off = di +
// dj * nx + dk * plane voxel ids, the 32 voxels of word w see bits [32 w +
// off, 32 w + off + 32) of axis a's bitset: two neighbouring words and a
// shift by the constant off & 31. So a word of 32 live bits is the OR of
// 12 shifted words (GATHER's 15 entries, the own voxel's three counted
// once), each masked where the offset crosses a row, plane or grid end
// (i + di or j + dj past the grid, where a voxel id offset would wrap
// into the next row or plane; past the top layer it reads bits beyond the
// last voxel, which the flag pass stores as 0), and the OR is masked to
// the owned voxels (ids below n_own * plane). 24 word loads per 32
// voxels, where a thread per voxel makes 15 single-bit loads.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define GSDF_DCW_HD static __host__ __device__ __forceinline__
#define GSDF_DCW_UNROLL _Pragma("unroll")
#else
#define GSDF_DCW_HD static inline
#define GSDF_DCW_UNROLL
#endif

namespace gsdf_dcw {

// The edge space: voxels a row, rows, edge layers; voxels a layer,
// voxels, owned voxels (the first n_own layers'), 32-voxel words per axis.
struct Space {
    int nx, ny, layers;
    long long plane, nvox, owned, words;
};

GSDF_DCW_HD Space make_space(int nk, int nj, int ni, int n_own) {
    Space s;
    s.nx = ni - 1;
    s.ny = nj - 1;
    s.layers = nk - 1;
    s.plane = (long long)s.nx * s.ny;
    s.nvox = s.plane * s.layers;
    s.owned = s.plane * n_own;
    s.words = (s.nvox + 31) / 32;
    return s;
}

GSDF_DCW_HD int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
    return __popc(x);
#else
    return __builtin_popcount(x);
#endif
}

GSDF_DCW_HD uint32_t load(const uint32_t* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// The bits b < n, n clamped to [0, 32].
GSDF_DCW_HD uint32_t bits_below(long long n) {
    return n <= 0 ? 0u : n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

// Bits [32 w + off, 32 w + off + 32) of a bitset of `words` words (off >=
// 0); bits past its last word are 0.
GSDF_DCW_HD uint32_t shifted(const uint32_t* bits, long long words, long long w, long long off) {
    const long long q = w + (off >> 5);
    const unsigned r = (unsigned)(off & 31);
    const uint32_t lo = q < words ? load(bits + q) : 0u;
    if (r == 0) return lo;
    const uint32_t hi = q + 1 < words ? load(bits + q + 1) : 0u;
    return (lo >> r) | (hi << (32 - r));
}

// The bits of word w whose voxel (i, j, k) has i + 1 < nx, j + 1 < ny,
// and whose voxel is owned.
struct Masks {
    uint32_t i1, j1, own;
};

// Voxel ids are below 2^31 (K5's shape_ok), so a word's first row and its
// j come from 32-bit divisions. A word meets at most 32 / nx + 2 rows.
GSDF_DCW_HD Masks word_masks(const Space& s, long long w) {
    const long long v0 = 32 * w;
    Masks m;
    m.own = bits_below(s.owned - v0);
    const unsigned row0 = (unsigned)v0 / (unsigned)s.nx;
    unsigned j = row0 % (unsigned)s.ny;
    uint32_t row_end = 0, last_row = 0;
    for (long long start = (long long)row0 * s.nx; start < v0 + 32; start += s.nx) {
        const long long end = start + s.nx;  // one past the row's last voxel
        if (end - 1 >= v0 && end - 1 < v0 + 32) row_end |= 1u << (end - 1 - v0);
        if (j == (unsigned)s.ny - 1u) last_row |= bits_below(end - v0) & ~bits_below(start - v0);
        j = j + 1u == (unsigned)s.ny ? 0u : j + 1u;
    }
    m.i1 = ~row_end;
    m.j1 = ~last_row;
    return m;
}

// The live bits of word w: its owned voxels with an active edge among the
// 15 they gather. ebits holds the three axes' bitsets, `words` apart.
GSDF_DCW_HD uint32_t live_word(const uint32_t* ebits, const Space& s, long long w,
                               const Masks& m) {
    if (m.own == 0u) return 0u;
    const long long step[3] = {1, s.nx, s.plane};
    const uint32_t edge_ok[3] = {m.i1, m.j1, 0xffffffffu};  // + plane: see the top
    uint32_t live = 0u;
    GSDF_DCW_UNROLL
    for (int a = 0; a < 3; ++a) {
        const int b = (a + 1) % 3, c = (a + 2) % 3;  // the two axes an offset may step on
        GSDF_DCW_UNROLL
        for (int u = 0; u < 2; ++u)
            GSDF_DCW_UNROLL
            for (int t = 0; t < 2; ++t) {
                const long long off = u * step[b] + t * step[c];
                const uint32_t ok = (u ? edge_ok[b] : 0xffffffffu) & (t ? edge_ok[c] : 0xffffffffu);
                live |= shifted(ebits + a * s.words, s.words, w, off) & ok;
            }
    }
    return live & m.own;
}

}  // namespace gsdf_dcw
