"""The port's grid kernels (K1 classified grid, K2 grid eval) against the
JAX package's Pallas kernels in interpret mode on the CPU, at the shapes
tests/test_pallas.py uses. On the CPU each wrapper runs its plain torch
version; tests/test_torch_cuda.py holds the CUDA kernels against those
plain versions on a card.

Tolerances: distances at atol=1e-6 (unit-scale trees; interpret mode
compiles the kernel body with XLA, which may contract a multiply-add).
The screw tree compares distances only: the Pallas trace replaces atan2
by a polynomial (gsdf_tpu/core/mathx.py), so a case bit may flip where a
corner sits within an ulp of the surface.
"""
import jax
import numpy as np
import pytest
import torch

from gsdf_tpu import Builder as JaxBuilder
from gsdf_tpu.eval.pallas_grid import classified_grid_pallas, evaluate_grid_pallas
from gsdf_tpu.forge import threads as jax_threads
from gsdf_tpu.ops import mc_emit as jax_mc_emit
from gsdf_tpu_torch import Builder as TorchBuilder
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.forge import threads as torch_threads
from gsdf_tpu_torch.ops import mc_emit

SHAPE = (18, 20, 22)


def _solid(b, t):
    """Screw-free tree of the slice's 3D node types."""
    hole = b.new_cylinder(0.12, 3.0)
    holes = b.union(*[b.translate(hole, 0.4 * np.cos(a), 0.4 * np.sin(a), 0)
                      for a in np.linspace(0, 5, 6)])
    body = b.smooth_union(
        0.15, b.new_cylinder(0.7, 0.6, 0.05), b.translate(b.new_cylinder(0.3, 1.2), 0, 0, 0.3)
    )
    body = b.intersection(b.difference(body, holes), b.new_cylinder(0.65, 2.0))
    return b.scale(body, 1.3)


def _screwed(b, t):
    return t.screw(b, 1.0, t.ISO(d=1.2, p=0.25, ext=True))


def _grid_args(jtree):
    bb = jtree.bounds().scale_centered((1.01, 1.01, 1.01))
    res = np.float32(jtree.bounds().diagonal() / 16)
    return bb.min, res


def _pair(recipe):
    return recipe(JaxBuilder(), jax_threads), recipe(TorchBuilder(), torch_threads)


def test_grid_eval_plain_matches_pallas():
    jtree, ttree = _pair(_solid)
    origin, res = _grid_args(jtree)
    ref = np.asarray(evaluate_grid_pallas(jtree, origin, res, SHAPE, jax.devices("cpu")[0]))
    got = gk.evaluate_grid(ttree, origin, res, SHAPE, "cpu").numpy()
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_classified_grid_plain_matches_pallas():
    jtree, ttree = _pair(_solid)
    origin, res = _grid_args(jtree)
    dist_ref, case_ref = classified_grid_pallas(
        jtree, origin, res, SHAPE, jax.devices("cpu")[0]
    )
    dist, cases = gk.classified_grid(ttree, origin, res, SHAPE, "cpu")
    assert cases.dtype == torch.uint8
    assert tuple(cases.shape) == tuple(s - 1 for s in SHAPE)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_ref), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(cases.numpy(), np.asarray(case_ref))
    assert (cases.numpy() != 0).sum() > 100


@pytest.mark.parametrize("kernel", ["grid_eval", "classified_grid"])
def test_screw_tree_distances_match_pallas(kernel):
    jtree, ttree = _pair(_screwed)
    origin, res = _grid_args(jtree)
    dev = jax.devices("cpu")[0]
    if kernel == "grid_eval":
        ref = evaluate_grid_pallas(jtree, origin, res, SHAPE, dev)
        got = gk.evaluate_grid(ttree, origin, res, SHAPE, "cpu")
    else:
        ref = classified_grid_pallas(jtree, origin, res, SHAPE, dev)[0]
        got = gk.classified_grid(ttree, origin, res, SHAPE, "cpu")[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_classify_matches_jax_on_one_grid():
    """Same distances in, identical case bytes out (ties at +-0 included)."""
    rng = np.random.default_rng(7)
    grid = rng.standard_normal((9, 10, 11)).astype(np.float32) * 0.05
    grid[rng.random(grid.shape) < 0.05] = -0.0
    grid[rng.random(grid.shape) < 0.05] = 0.0
    res = np.float32(0.02)
    index, active = jax_mc_emit.classify(jax.numpy.asarray(grid), res)
    ref = np.where(np.asarray(active), np.asarray(index), 0)
    got = mc_emit.effective_cases(torch.from_numpy(grid), res).numpy()
    np.testing.assert_array_equal(got, ref)


def test_grid_positions_use_global_index():
    """A z-slab's positions equal the whole grid's rows (the slab rule)."""
    origin, res = np.float32([-1.1, 0.3, -2.7]), np.float32(0.013)
    whole = gk.grid_positions(origin, res, (12, 3, 4), "cpu")
    slab = gk.grid_positions(origin, res, (5, 3, 4), "cpu", k0=7)
    assert torch.equal(whole[7:], slab)


def test_wrappers_reject_unsupported_devices():
    _, ttree = _pair(_solid)
    with pytest.raises(ValueError):
        gk.evaluate_grid(ttree, np.zeros(3), 0.1, SHAPE, "meta")
    with pytest.raises(ValueError):
        gk.classified_grid(ttree, np.zeros(3), 0.1, (1, 4, 4), "cpu")
