"""Random CSG trees through the port's compact path against the JAX
package's (CPU).

The trees come from the JAX package's own path fuzz generator
(tests/test_fuzz_paths.py `_random_tree`, the seeds of its
test_all_paths_agree) and are carried over with `from_reference_tree`;
every unary op of the reference's randomized set (rotate, scale, offset,
shell, symmetry, twist, circular array, elongate, translate, array) and
the extrude/revolve leaves reach the port this way. Each tree renders at
diag/32 through `compact_field_render` of both packages, the JAX one op
by op (`jax.disable_jit`). Cube ids and case bytes must be equal; the
owner-edge t within 1e-4 of a voxel edge (ROADMAP item 4's rule: corner
distances differ by an ulp of sin, cos or atan2, which the interpolation
amplifies where an edge nearly cancels). Payloads, not meshes, are
compared: where the decoder cannot resolve an owner the JAX package falls
back to render_indexed, which the port does not have yet.
"""
import jax
import numpy as np
import pytest
from test_fuzz_paths import _random_tree

from gsdf_tpu.ops.compact_field import compact_field_render as jax_compact_field_render
from gsdf_tpu_torch.convert import from_reference_tree
from gsdf_tpu_torch.ops.compact_field import compact_field_render
from gsdf_tpu_torch.render.flat import FlatRenderer

T_TOL = 1e-4  # of a voxel edge


@pytest.mark.parametrize("seed", range(10))
def test_random_tree_payload_matches_jax(seed):
    jtree = _random_tree(np.random.default_rng(seed))
    if jtree is None:
        pytest.skip("builder rejected random combination")
    bbd = jtree.bounds().diagonal()
    if not np.isfinite(bbd) or bbd <= 0 or jtree.bounds().is_empty():
        pytest.skip("degenerate/empty bounds")
    ttree = from_reference_tree(jtree)
    assert ttree.tree_hash() == jtree.tree_hash()
    fr = FlatRenderer(ttree, bbd / 32, "cpu")
    shape = fr.shape()
    with jax.disable_jit():
        jids, jcases, jt, _ = jax_compact_field_render(
            jtree, fr.origin, fr.res, shape, jax.devices("cpu")[0]
        )
    ids, cases, t = compact_field_render(ttree, fr.origin, fr.res, shape, "cpu")
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cases, jcases)
    assert len(t) == len(jt)
    dt = np.abs(t.astype(np.float64) - jt.astype(np.float64))
    assert dt.max(initial=0.0) <= T_TOL, f"t drift {dt.max():.2e} > {T_TOL} voxel"
