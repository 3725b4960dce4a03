"""The port's CUDA kernels (K1 classified grid, K2 grid eval) against their
plain torch versions on a card. Every test here needs an NVIDIA GPU and
nvcc and skips without them. This file imports no JAX, so on a machine
without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: case grids exact; distances within 1e-5 * max(1, |d|), the
last-ulp difference of CUDA's atan2f and torch.atan2.
"""
import numpy as np
import pytest
import torch

from gsdf_tpu_torch import Builder, flagships
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.forge import threads
from gsdf_tpu_torch.render.flat import FlatRenderer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _solid():
    b = Builder()
    hole = b.new_cylinder(0.12, 3.0)
    holes = b.union(*[b.translate(hole, 0.4 * np.cos(a), 0.4 * np.sin(a), 0)
                      for a in np.linspace(0, 5, 6)])
    body = b.smooth_union(
        0.15, b.new_cylinder(0.7, 0.6, 0.05), b.translate(b.new_cylinder(0.3, 1.2), 0, 0, 0.3)
    )
    return b.scale(b.intersection(b.difference(body, holes), b.new_cylinder(0.65, 2.0)), 1.3)


def _screw():
    return threads.screw(Builder(), 1.0, threads.ISO(d=1.2, p=0.25, ext=True))


TREES = {
    "solid": _solid,
    "screw": _screw,
    "flange": flagships.build_flange,
    "showerhead": flagships.build_showerhead,
}


@pytest.mark.parametrize("name", list(TREES))
def test_kernels_match_plain(name, cuda_device):
    tree = TREES[name]()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / 90, cuda_device)
    args = (tree, fr.origin, fr.res, fr.shape(), cuda_device)
    before = dict(gk.LAUNCHES)
    dist, cases = gk.classified_grid(*args)
    dist2 = gk.evaluate_grid(*args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["classified_grid"] == before["classified_grid"] + 1
    assert gk.LAUNCHES["grid_eval"] == before["grid_eval"] + 1
    ref_dist, ref_cases = gk.classified_grid_plain(*args)
    tol = 1e-5 * ref_dist.abs().clamp(min=1.0)
    assert bool(((dist - ref_dist).abs() <= tol).all())
    assert torch.equal(dist, dist2)
    assert torch.equal(cases, ref_cases)
    assert int((cases != 0).sum()) > 100


def test_grid_eval_slab_offset(cuda_device):
    """A z-slab launched with k0 equals the whole grid's planes bit for bit."""
    tree = _solid()
    origin, res = np.float32([-1.0, -1.0, -1.0]), np.float32(0.03)
    whole = gk.evaluate_grid(tree, origin, res, (40, 33, 65), cuda_device)
    slab = gk.evaluate_grid(tree, origin, res, (9, 33, 65), cuda_device, k0=17)
    assert torch.equal(whole[17:26], slab)


def test_render_compact_on_card_matches_plain_payload(cuda_device):
    """The card's compact path gives the plain version's triangles."""
    tree = flagships.build_flange()
    res = tree.bounds().diagonal() / 120
    verts, tri = FlatRenderer(tree, res, cuda_device).render_compact()
    fr = FlatRenderer(tree, res, cuda_device)
    d, c = gk.classified_grid_plain(tree, fr.origin, fr.res, fr.shape(), cuda_device)
    from gsdf_tpu_torch.native import mc_decode
    from gsdf_tpu_torch.ops.compact_field import compact_emit

    ids, idx8, t = compact_emit(d, c)
    v_ref, tri_ref = mc_decode(
        ids.to(torch.int32).cpu().numpy().view(np.uint32), idx8.cpu().numpy(),
        t.cpu().numpy(), fr.nx, fr.ny, fr.nz, fr.origin, fr.res,
    )
    np.testing.assert_array_equal(tri, tri_ref)
    np.testing.assert_allclose(verts, v_ref, rtol=0, atol=1e-5)
