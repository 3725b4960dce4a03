"""K5's word-level index arithmetic (gsdf_tpu_torch/csrc/gsdf_dc_words.cuh)
against the plain version, on the CPU.

The header is built by g++ with a host loop that runs K5's scan pass in
order, word by word: each axis's edge-rank directory (the active edges
of the 32-voxel words before a word) and the live voxel ids from each
word's live bits. Both are held against what the plain version derives
from the same corners: the ballot words and ranks from `edge_flags_plain`,
the live set from `live_voxels_plain` (voxel_sums_plain's), on seeded
sign fields (numpy, signed zeros among them) whose rows of nx voxels make
word, row and plane ends fall everywhere in a word: nx in {2, 31, 32, 33,
63, 65}, fewer owned layers than layers, and a slab at k0 > 0 held to the
whole grid's live voxels of its owned layers. The slot K5 writes an edge
at (axis base + word rank + active bits below it in its word) must be the
edge's place in the ascending id list.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gsdf_tpu_torch.ops import dc_emit

CSRC = dc_emit.__file__.rsplit("/ops/", 1)[0] + "/csrc"

SHIM = r"""
#include "gsdf_dc_words.cuh"
// K5's scan pass (dc_mesh.cu scan_kernel) one word at a time: the ranks,
// the live ids in ascending order and the four counts.
extern "C" void scan(const uint32_t* ebits, int nk, int nj, int ni, int n_own, int32_t* edir,
                     int32_t* ids, long long* counts) {
    const gsdf_dcw::Space s = gsdf_dcw::make_space(nk, nj, ni, n_own);
    long long run[3] = {0, 0, 0}, n = 0;
    for (long long w = 0; w < s.words; ++w) {
        for (int a = 0; a < 3; ++a) {
            edir[a * s.words + w] = (int32_t)run[a];
            run[a] += gsdf_dcw::popc(ebits[a * s.words + w]);
        }
        uint32_t bits = gsdf_dcw::live_word(ebits, s, w, gsdf_dcw::word_masks(s, w));
        for (; bits != 0u; bits &= bits - 1u) ids[n++] = (int32_t)(32 * w + __builtin_ctz(bits));
    }
    for (int a = 0; a < 3; ++a) counts[a] = run[a];
    counts[3] = n;
}
"""


@pytest.fixture(scope="module")
def words_lib(tmp_path_factory):
    """csrc/gsdf_dc_words.cuh built by g++ around the scan loop above."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not installed")
    d = tmp_path_factory.mktemp("dc_words")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libdcwords.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror", "-I", CSRC,
                    "-o", str(so), str(d / "shim.cpp")], check=True, capture_output=True,
                   timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.scan.restype = None
    lib.scan.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    return lib


def sign_field(shape, seed, negative=0.3):
    """Corner values whose signs are seeded (`negative` of them below
    zero, a few of them -0.0 or +0.0): the edge flags test sign bits."""
    rng = np.random.default_rng(seed)
    v = np.abs(rng.normal(size=shape)).astype(np.float32) + np.float32(0.1)
    v[rng.random(shape) < negative] *= -1
    zeros = rng.random(shape) < 0.05
    v[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, np.float32(-0.0), np.float32(0.0))
    return torch.from_numpy(v)


def ballot_words(flags):
    """(3, words) uint32: each axis's flags (3, L, ny, nx) as a bitset over
    the voxel ids, bit v & 31 of word v >> 5, as K5's flag pass stores it."""
    bits = flags.reshape(3, -1).numpy()
    words = -(-bits.shape[1] // 32)
    padded = np.zeros((3, words * 32), np.uint64)
    padded[:, :bits.shape[1]] = bits
    return (padded.reshape(3, words, 32) << np.arange(32, dtype=np.uint64)).sum(-1).astype(
        np.uint32)


def header_scan(lib, ebits, shape, n_own):
    """(edir (3, words), live ids, counts) from the g++ build."""
    nk, nj, ni = shape
    ebits = np.ascontiguousarray(ebits)
    edir = np.empty_like(ebits, dtype=np.int32)
    ids = np.empty(n_own * (nj - 1) * (ni - 1), np.int32)
    counts = np.empty(4, np.int64)
    lib.scan(ebits.ctypes.data, nk, nj, ni, n_own, edir.ctypes.data, ids.ctypes.data,
             counts.ctypes.data)
    return edir, ids[:counts[3]], counts


def plain_scan(grid, n_own):
    """The same from the plain version: ballot words and ranks from
    edge_flags_plain, the live set from live_voxels_plain."""
    flags = dc_emit.edge_flags_plain(grid)
    ebits = ballot_words(flags)
    popc = np.unpackbits(ebits.view(np.uint8), axis=-1).reshape(3, -1, 32).sum(-1)
    edir = (np.cumsum(popc, axis=1) - popc).astype(np.int32)
    eid = torch.nonzero(flags.reshape(-1)).squeeze(1)
    live = dc_emit.live_voxels_plain(eid, tuple(grid.shape), n_own).numpy()
    return ebits, edir, eid.numpy(), live


#: (corner shape, owned layers or None for all, negative share, seed)
GRIDS = [
    ((6, 5, 3), None, 0.3, 0),  # nx = 2: 16 rows a word
    ((5, 4, 32), None, 0.3, 1),  # nx = 31
    ((5, 6, 33), 3, 0.3, 2),  # nx = 32: rows on words
    ((4, 7, 34), None, 0.05, 3),  # nx = 33: sparse edges
    ((5, 3, 64), 2, 0.3, 4),  # nx = 63
    ((6, 4, 66), None, 0.5, 5),  # nx = 65
    ((3, 2, 34), 1, 0.3, 6),  # one row a plane, one owned layer
    ((9, 3, 17), 5, 0.2, 7),  # nx = 16, planes of 32 voxels
]


@pytest.mark.parametrize("shape, n_own, negative, seed", GRIDS,
                         ids=[f"{s[2] - 1}x{s[1] - 1}x{s[0] - 1}-own{o}" for s, o, _, _ in GRIDS])
def test_word_scan_matches_plain(words_lib, shape, n_own, negative, seed):
    """Live ids, edge-rank directory and counts of the header's scan equal
    the plain version's; every active edge's slot is its place in the
    ascending id list."""
    grid = sign_field(shape, seed, negative)
    own = shape[0] - 1 if n_own is None else n_own
    ebits, edir_plain, eid, live_plain = plain_scan(grid, own)
    edir, ids, counts = header_scan(words_lib, ebits, shape, own)
    np.testing.assert_array_equal(ids, live_plain)
    np.testing.assert_array_equal(edir, edir_plain)
    per_axis = np.array([int(np.unpackbits(ebits[a].view(np.uint8)).sum()) for a in range(3)])
    np.testing.assert_array_equal(counts, [*per_axis, len(live_plain)])
    # K5's edge slot: axis base + the word's rank + the active bits below
    nvox = (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
    axis, v = eid // nvox, eid % nvox
    base = np.concatenate([[0], np.cumsum(per_axis)[:2]])[axis]
    below = (ebits[axis, v >> 5] & ((np.uint32(1) << (v & 31).astype(np.uint32)) - 1))
    slots = base + edir[axis, v >> 5] + np.unpackbits(below.view(np.uint8).reshape(-1, 4),
                                                      axis=1).sum(1)
    np.testing.assert_array_equal(slots, np.arange(len(eid)))
    assert len(live_plain) > 0 and len(eid) > 0


@pytest.mark.parametrize("k0, n_own", [(3, 2), (6, 4)])
def test_word_scan_on_a_slab(words_lib, k0, n_own):
    """A slab's corners (n_own + 2 planes from k0, its top edge layer a
    halo): the header's live ids are the whole grid's live voxels of the
    owned layers [k0, k0 + n_own), less k0 planes."""
    whole = sign_field((14, 9, 34), 11)
    _, _, _, live_whole = plain_scan(whole, 13)
    slab = whole[k0:k0 + n_own + 2].contiguous()
    ebits, _, _, live_slab = plain_scan(slab, n_own)
    _, ids, _ = header_scan(words_lib, ebits, tuple(slab.shape), n_own)
    plane = 8 * 33
    want = live_whole[(live_whole >= k0 * plane) & (live_whole < (k0 + n_own) * plane)]
    np.testing.assert_array_equal(ids, want - k0 * plane)
    np.testing.assert_array_equal(ids, live_slab)
    assert len(ids) > 0
