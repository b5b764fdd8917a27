"""Tests for auxiliary components: batched BCGS patch solver, checkpoint,
Morton partitioning."""

import numpy as np
import jax.numpy as jnp

from pressurepoissonsolver_tpu.checkpoint import load_checkpoint, save_checkpoint
from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import refined_tree, uniform_tree
from pressurepoissonsolver_tpu.ops.level_ops import Level
from pressurepoissonsolver_tpu.ops.patch_bcgs import BcgsPatchSolver
from pressurepoissonsolver_tpu.parallel.partition import (
    block_partition,
    cut_faces,
    morton_order,
    reorder_level,
)


def test_bcgs_patch_solver_matches_spectral():
    t = refined_tree(2, 2, 1)
    h = DomainHierarchy(t, n=4)
    lvl = Level(h.finest)
    rng = np.random.default_rng(0)
    f = jnp.asarray(rng.standard_normal((lvl.P, 4, 4)))
    g = jnp.asarray(rng.standard_normal((lvl.num_ifaces, lvl.m)))
    u_spec = lvl.patch_solve(f, g)
    bcgs = BcgsPatchSolver(lvl, tol=1e-13, max_iter=500)
    u_it = bcgs.patch_solve(f, g)
    np.testing.assert_allclose(np.asarray(u_it), np.asarray(u_spec), rtol=1e-8, atol=1e-9)


def test_checkpoint_roundtrip(tmp_path):
    t = refined_tree(2, 2, 1)
    h = DomainHierarchy(t, n=4)
    lvl = Level(h.finest)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((lvl.P, 4, 4))
    gamma = rng.standard_normal((lvl.num_ifaces, lvl.m))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, t, 4, {"u": u, "gamma": gamma}, meta={"iteration": 7})
    tree2, n2, arrays, meta = load_checkpoint(path)
    assert n2 == 4
    assert len(tree2.nodes) == len(t.nodes)
    np.testing.assert_allclose(arrays["u"], u)
    np.testing.assert_allclose(arrays["gamma"], gamma)
    assert int(meta["iteration"]) == 7
    # the restored tree builds an identical domain
    h2 = DomainHierarchy(tree2, n=4)
    np.testing.assert_array_equal(h2.finest.ids, h.finest.ids)
    np.testing.assert_array_equal(h2.finest.nbr_type, h.finest.nbr_type)


def test_morton_order_reduces_cut():
    t = uniform_tree(2, 4)  # 8x8 patches
    h = DomainHierarchy(t, n=4)
    lvl = h.finest
    perm = morton_order(lvl)
    re = reorder_level(lvl, perm)
    # reordered level is still a valid patch graph: apply matches after
    # permuting in/out
    l1, l2 = Level(lvl), Level(re)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((lvl.num_patches, 4, 4))
    a1 = np.asarray(l1.apply(jnp.asarray(u)))
    a2 = np.asarray(l2.apply(jnp.asarray(u[perm])))
    np.testing.assert_allclose(a2, a1[perm], rtol=1e-12)
    # Morton + block partition cuts no more faces than id-order partition
    shards = 8
    cut_m = cut_faces(re, block_partition(re.num_patches, shards))
    cut_id = cut_faces(lvl, block_partition(lvl.num_patches, shards))
    assert cut_m <= cut_id


def test_richardson_matches_cg_on_spd_system():
    """Preconditioned Richardson converges on a diagonally-dominant SPD
    system and agrees with CG's solution."""
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.krylov import cg, richardson

    rng = np.random.default_rng(0)
    N = 40
    B = rng.standard_normal((N, N))
    A_np = B @ B.T + N * np.eye(N)
    b_np = rng.standard_normal(N)
    A = lambda x: jnp.asarray(A_np) @ x
    # a contractive preconditioner (rho(I - MA) < 1, as the GMG cycle is)
    Minv = 0.7 * np.linalg.inv(A_np)
    M = lambda r: jnp.asarray(Minv) @ r
    r1 = richardson(A, jnp.asarray(b_np), M=M, tol=1e-12, max_iter=500)
    r2 = cg(A, jnp.asarray(b_np), M=M, tol=1e-12, max_iter=500)
    assert float(r1.residual_norm / r1.r0_norm) < 1e-11
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x), atol=1e-9)
    assert int(r2.iterations) <= int(r1.iterations)


def test_weighted_cg_composite_solve():
    """Volume-weighted PCG solves the adaptive composite system (the
    operator + V-cycle are exactly D-self-adjoint)."""
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    h = DomainHierarchy(refined_tree(2, 3, 1), n=8)
    s = PoissonSolver(h, SolveOptions(tol=1e-11, krylov="cg"))
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    res = s.solve(jnp.asarray(f))
    rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
    assert rep["residual"] < 1e-10
    assert int(res.iterations) < 25


def test_profiling_op_report():
    """op_report returns timing + roofline fields for every core op."""
    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import uniform_tree
    from pressurepoissonsolver_tpu.ops.level_ops import Level
    from pressurepoissonsolver_tpu.utils import profiling

    import math

    h = DomainHierarchy(uniform_tree(2, 2), n=4)
    rep = profiling.op_report(Level(h.finest), reps=2)
    assert set(rep) == {"interpolate", "apply", "patch_solve", "smooth"}
    for v in rep.values():
        # NaN = the designed "noise-dominated measurement" flag: at this
        # toy size on CPU the op is cheaper than launch jitter
        assert math.isnan(v["ms"]) or (v["ms"] > 0 and v["roofline_pct"] > 0)
    assert "gnnz_per_s" in rep["apply"]


def test_factored_denominator_matches_dense():
    """The factored per-axis eigen rows materialize the same denominator
    as the old dense per-cell table (f64 sums, cast after)."""
    import numpy as np

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.ops.level_ops import (
        _build_solver_tables,
        _denom_of,
    )
    from pressurepoissonsolver_tpu.ops import transforms as tr

    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=8, neumann=["x_lo"])
    pl = h.finest
    st = _build_solver_tables(pl, jnp.float64, np.arange(pl.num_patches))
    got = np.asarray(_denom_of(st, 2, 8))
    # dense reference, per sorted slot
    order = np.asarray(st.perm)
    for i, p in enumerate(order[:20]):
        acc = np.zeros((8, 8))
        for a in range(2):
            delta = tr.axis_transforms(
                bool(pl.neumann[p, 2 * a]), bool(pl.neumann[p, 2 * a + 1])
            )[2]
            lam = tr.axis_eigenvalues(8, float(pl.spacings[p, a]), delta)
            shape = [1, 1]
            shape[1 - a] = 8
            acc = acc + lam.reshape(shape)
        assert np.abs(got[i] - acc).max() == 0.0, (i, p)
