"""Native (C++) table generation must match the Python reference builders
bit-for-bit."""

import time

import numpy as np
import pytest

from pressurepoissonsolver_tpu import native
from pressurepoissonsolver_tpu.domain import extract_level
from pressurepoissonsolver_tpu.geometry import Tree, refined_tree, uniform_tree
from pressurepoissonsolver_tpu.iface import build_iface_tables


def _through_file(tree):
    """``tree`` written with ``Tree.to_file`` and read back."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "t.bin")
        tree.to_file(p)
        return Tree.from_file(p, tree.D)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native tablegen unavailable"
)


@pytest.mark.parametrize(
    "maker,D",
    [
        (lambda: uniform_tree(2, 3), 2),
        (lambda: refined_tree(2, 3, 2), 2),
        (lambda: refined_tree(3, 2, 1), 3),
        (lambda: _through_file(refined_tree(3, 3, 1)), 3),
    ],
)
@pytest.mark.parametrize("neumann", [False, True])
def test_native_matches_python(maker, D, neumann):
    tree = maker()
    for lvl_no in range(tree.num_levels - 1, -1, -1):
        py_pl = extract_level(tree, lvl_no, n=4, neumann=neumann)
        py_t = build_iface_tables(py_pl)
        nat = native.build_level_native(tree, lvl_no, 4, neumann)
        assert nat is not None
        na_pl, na_t = nat
        np.testing.assert_array_equal(na_pl.ids, py_pl.ids)
        np.testing.assert_allclose(na_pl.starts, py_pl.starts)
        np.testing.assert_allclose(na_pl.spacings, py_pl.spacings)
        np.testing.assert_array_equal(na_pl.refine_level, py_pl.refine_level)
        np.testing.assert_array_equal(na_pl.parent_id, py_pl.parent_id)
        np.testing.assert_array_equal(na_pl.orth_on_parent, py_pl.orth_on_parent)
        np.testing.assert_array_equal(na_pl.neumann, py_pl.neumann)
        np.testing.assert_array_equal(na_pl.nbr_type, py_pl.nbr_type)
        np.testing.assert_array_equal(na_pl.nbr_slot, py_pl.nbr_slot)
        np.testing.assert_array_equal(na_pl.coarse_orth, py_pl.coarse_orth)
        np.testing.assert_array_equal(na_pl.fine_nbr_slots, py_pl.fine_nbr_slots)
        assert na_t.num_ifaces == py_t.num_ifaces
        np.testing.assert_array_equal(na_t.iface_side_idx, py_t.iface_side_idx)
        np.testing.assert_array_equal(na_t.iface_side_mask, py_t.iface_side_mask)
        np.testing.assert_array_equal(na_t.contrib_patch, py_t.contrib_patch)
        np.testing.assert_array_equal(na_t.contrib_side, py_t.contrib_side)
        np.testing.assert_array_equal(na_t.contrib_iface, py_t.contrib_iface)
        np.testing.assert_array_equal(na_t.contrib_case, py_t.contrib_case)


def test_native_speedup_large_mesh():
    tree = uniform_tree(2, 7)  # 4096 leaf patches
    t0 = time.time()
    py_pl = extract_level(tree, 6, n=4)
    py_t = build_iface_tables(py_pl)
    t_py = time.time() - t0
    t0 = time.time()
    na_pl, na_t = native.build_level_native(tree, 6, 4, False)
    t_na = time.time() - t0
    assert na_pl.num_patches == py_pl.num_patches == 4096
    assert na_t.num_ifaces == py_t.num_ifaces
    # the native path should be dramatically faster (conservative bound)
    assert t_na < t_py


def test_sharded_hierarchy_native_tables_match_python():
    """Permuted+padded native tables == tables rebuilt in Python."""
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu import iface as iface_mod
    from pressurepoissonsolver_tpu import native as native_mod
    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.ops.level_ops import Level

    if not native_mod.available():
        pytest.skip("native tablegen unavailable")
    t = refined_tree(2, 3, 1)
    h_native = DomainHierarchy(t, n=4, num_shards=8, use_native=True)
    h_python = DomainHierarchy(t, n=4, num_shards=8, use_native=False)
    pl_n, pl_p = h_native.finest, h_python.finest
    assert h_native.iface_tables[0] is not None
    np.testing.assert_array_equal(pl_n.ids, pl_p.ids)
    # the op pipeline built from both table sets must agree exactly
    lvl_n, lvl_p = Level(pl_n), Level(pl_p)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((pl_n.num_patches, 4, 4)))
    np.testing.assert_allclose(
        np.asarray(lvl_n.apply(u)), np.asarray(lvl_p.apply(u)), rtol=1e-13
    )
    g_n, g_p = lvl_n.interpolate(u), lvl_p.interpolate(u)
    assert g_n.shape[0] == g_p.shape[0]
