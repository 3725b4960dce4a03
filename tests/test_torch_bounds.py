"""The port's kernel bounds (gsdf_tpu_torch/bounds.py) on the CPU: the
operation counter on trees whose count is known by hand, its linearity in
the number of points on the golden parts, and the byte and bound
arithmetic that chip_smoke.py prints beside each kernel's time."""
import numpy as np
import pytest
import torch

from gsdf_tpu_torch import Builder, bounds, flagships
from gsdf_tpu_torch.eval import grid_kernels as gk
from gsdf_tpu_torch.ops import mc_emit

#: sqrt(x*x + y*y + z*z) - r: 3 mul, 2 add, sqrt, sub
SPHERE_OPS = 7


def test_sphere_counts_by_hand():
    assert bounds.tree_ops_per_point(Builder().new_sphere(1.0)) == SPHERE_OPS


def test_two_child_union_counts_by_hand():
    """Two spheres and the min of their distances."""
    b = Builder()
    tree = b.union(b.new_sphere(1.0), b.new_sphere(0.5))
    assert bounds.tree_ops_per_point(tree) == 2 * SPHERE_OPS + 1


def test_translated_child_counts_its_offset():
    """A Translate subtracts its offset: 3 more operations."""
    b = Builder()
    tree = b.union(b.new_sphere(1.0), b.translate(b.new_sphere(0.5), 1.0, 0.0, 0.0))
    assert bounds.tree_ops_per_point(tree) == 2 * SPHERE_OPS + 3 + 1


@pytest.mark.parametrize("name", ["flange", "showerhead", "bolt", "knurled"])
def test_golden_part_counts_linear_in_points(name):
    tree = getattr(flagships, f"build_{name}")()
    per = bounds.tree_ops_per_point(tree, 100)
    assert per == bounds.tree_ops_per_point(tree, 1000, seed=1) > 100


def test_counter_skips_casts_views_indexing_and_integers():
    x = torch.rand(10, 3)
    _, ops = bounds.count_ops(lambda: (x.double().float()[:, 0], x[..., 1:].clone(),
                                       torch.arange(10) * 3, torch.stack([x, x])))
    assert ops == 0
    _, ops = bounds.count_ops(lambda: torch.amax(x, dim=-1) + torch.maximum(x, x).sum())
    assert ops == 10 * 2 + 30 + (30 - 1) + 10  # amax folds 2 of 3; sum folds 29 of 30


def test_classification_counts_ten_per_cube():
    """8 sign tests, |d0| and its compare; the case arithmetic is integer."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 6, 7)).astype(np.float32))
    _, ops = bounds.count_ops(mc_emit.effective_cases, g, np.float32(0.1))
    assert ops == 10 * 4 * 5 * 6


def test_kernel_bytes_and_bound():
    assert bounds.kernel_bytes("classified_grid", corners=1000, cubes=729) == 4729
    assert bounds.kernel_bytes("grid_eval", corners=1000) == 4000
    assert bounds.kernel_bytes("compact_active", cubes=4096, active=257) == 4096 + 4 * 257 + 32 + 24
    b = bounds.bound(ops=33.5e9, nbytes=1e9)
    assert b["bound_ms"] == pytest.approx(1.0) and b["bound_by"] == "operations"
    assert b["published_fp32_ms"] == pytest.approx(0.5)
    b = bounds.bound(ops=0, nbytes=6.7e9)
    assert b["bound_ms"] == pytest.approx(2.0) and b["bound_by"] == "bytes"


def test_k1_plain_counts_tree_and_classification():
    """The plain K1 runs the tree's operations at every corner, the
    classification's at every cube, and 2 per index of each axis to make
    the positions (origin + index * res)."""
    tree = Builder().new_sphere(1.0)
    shape = (4, 5, 6)
    origin, res = np.float32([-1.2, -1.2, -1.2]), np.float32(0.4)
    _, ops = bounds.count_ops(gk.classified_grid_plain, tree, origin, res, shape, "cpu")
    assert ops == SPHERE_OPS * 4 * 5 * 6 + 10 * 3 * 4 * 5 + 2 * (4 + 5 + 6)
