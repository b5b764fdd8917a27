"""Operator/patch-solver consistency tests.

The composite operator (stencil path) and the spectral patch solver are
two independent formulations of the same per-patch linear system, so
``apply_with_interface(patch_solve(f, g), g) == f`` must hold exactly (to
f64 roundoff) for ANY interface values g — a strong cross-check of both.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import Tree, refined_tree, uniform_tree
from pressurepoissonsolver_tpu.ops.level_ops import Level


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape))


def _level(D=2, n=4, levels=2, neumann=False, adaptive=False):
    t = refined_tree(D, levels, 1) if adaptive else uniform_tree(D, levels)
    h = DomainHierarchy(t, n=n, neumann=neumann)
    return Level(h.finest)


@pytest.mark.parametrize("neumann", [False, True])
@pytest.mark.parametrize("adaptive", [False, True])
def test_patch_solve_inverts_stencil_2d(neumann, adaptive):
    lvl = _level(D=2, n=4, levels=2, neumann=neumann, adaptive=adaptive)
    P = lvl.P
    f = _rand((P, 4, 4))
    if neumann:
        # per-patch solvability: all-Neumann patches need zero-mean f (the
        # solver pins the DC mode; the identity holds in the complement)
        allneu = np.asarray(lvl.pl.neumann).all(axis=1)
        fn = np.array(f)
        fn[allneu] -= fn[allneu].mean(axis=(1, 2), keepdims=True)
        f = jnp.asarray(fn)
    gamma = _rand((lvl.num_ifaces, lvl.m), seed=1)
    u = lvl.patch_solve(f, gamma)
    f2 = lvl.apply_with_interface(u, gamma)
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f), rtol=1e-11, atol=1e-9)


def test_patch_solve_inverts_stencil_3d():
    lvl = _level(D=3, n=4, levels=2)
    f = _rand((lvl.P, 4, 4, 4))
    gamma = _rand((lvl.num_ifaces, lvl.m), seed=2)
    u = lvl.patch_solve(f, gamma)
    f2 = lvl.apply_with_interface(u, gamma)
    np.testing.assert_allclose(np.asarray(f2), np.asarray(f), rtol=1e-11, atol=1e-9)


def test_smoother_fixed_point():
    """If A u = f then one block-Jacobi sweep leaves u unchanged
    (SchurHelper::solveWithSolution with converged traces)."""
    lvl = _level(D=2, n=8, levels=2)
    u = _rand((lvl.P, 8, 8), seed=3)
    f = lvl.apply(u)
    u2 = lvl.smooth(f, u)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u), rtol=1e-10, atol=1e-10)


def test_interpolation_normal_is_average():
    """On a same-level interface, gamma = (trace_L + trace_R)/2."""
    lvl = _level(D=2, n=4, levels=2)
    u = _rand((lvl.P, 4, 4), seed=4)
    gamma = lvl.interpolate(u)
    pl = lvl.pl
    t = lvl.tables
    # find an east-west normal pair
    p = int(np.argmax(pl.nbr_type[:, 1] == 1))
    q = int(pl.nbr_slot[p, 1])
    iface = int(t.iface_side_idx[p, 1])
    left = np.asarray(u)[p, :, -1]
    right = np.asarray(u)[q, :, 0]
    np.testing.assert_allclose(
        np.asarray(gamma)[iface], 0.5 * (left + right), rtol=1e-12
    )


def test_interface_weights_sum_to_one():
    """Interpolating the constant-1 field must give gamma = 1 on every
    interface (weights of the two sides sum to 1 for all iface types)."""
    for adaptive in (False, True):
        for D in (2, 3):
            lvl = _level(D=D, n=4, levels=2, adaptive=adaptive)
            u = jnp.ones((lvl.P,) + (4,) * D)
            gamma = lvl.interpolate(u)
            np.testing.assert_allclose(np.asarray(gamma), 1.0, rtol=1e-12)


def test_apply_constant_interior_zero():
    """A constant field has zero Laplacian away from Dirichlet walls, and
    exactly zero everywhere with Neumann BCs."""
    lvl = _level(D=2, n=4, levels=2, neumann=True, adaptive=True)
    u = jnp.ones((lvl.P, 4, 4))
    au = lvl.apply(u)
    np.testing.assert_allclose(np.asarray(au), 0.0, atol=1e-12)


def test_apply_matches_dense_symmetric_uniform():
    """On a uniform mesh the composite operator is symmetric."""
    lvl = _level(D=2, n=4, levels=2)
    N = lvl.P * 16
    A = np.zeros((N, N))
    for j in range(N):
        e = np.zeros(N)
        e[j] = 1.0
        A[:, j] = np.asarray(lvl.apply(jnp.asarray(e.reshape(lvl.P, 4, 4)))).ravel()
    np.testing.assert_allclose(A, A.T, rtol=1e-10, atol=1e-10)
    # and negative definite (Dirichlet)
    w = np.linalg.eigvalsh(A)
    assert w.max() < 0


class TestQuadraticClosure:
    """Higher-order 2D refinement-boundary closures
    (reference StencilHelper2d.h:222-346, MatrixHelper2d.cpp:30-122)."""

    def _setup(self, n=8):
        from pressurepoissonsolver_tpu.domain import DomainHierarchy
        from pressurepoissonsolver_tpu.geometry import refined_tree
        from pressurepoissonsolver_tpu.ops.level_ops import Level

        t = refined_tree(2, 3, 1)
        h = DomainHierarchy(t, n=n)
        return h, Level(h.finest, iface_scheme="quadratic")

    def test_csr_matches_matrix_free(self):
        from pressurepoissonsolver_tpu.matrix import assemble_composite

        h, lvl = self._setup()
        A = assemble_composite(h.finest, scheme="quadratic")
        rng = np.random.default_rng(0)
        u = rng.standard_normal((lvl.P, 8, 8))
        ref = np.asarray(lvl.apply(jnp.asarray(u))).ravel()
        np.testing.assert_allclose(A @ u.ravel(), ref, rtol=1e-10, atol=1e-9)

    def test_exact_on_quadratics_at_refinement_boundaries(self):
        """lap(x^2+y^2) = 4 exactly on interior + refinement rows; the
        bilinear closure has an O(1) truncation there."""
        from pressurepoissonsolver_tpu.ops.level_ops import Level

        h, lvl = self._setup()
        n = 8
        cc = h.finest.cell_centers()
        uq = cc[..., 0] ** 2 + cc[..., 1] ** 2
        phys = h.finest.nbr_type == 0
        mask = np.ones((lvl.P, n, n), dtype=bool)
        for p in range(lvl.P):
            for s in range(4):
                if phys[p, s]:
                    a = s // 2
                    sl = [p, slice(None), slice(None)]
                    sl[1 + (1 - a)] = 0 if s % 2 == 0 else n - 1
                    mask[tuple(sl)] = False
        au = np.asarray(lvl.apply(jnp.asarray(uq)))
        assert np.abs(au - 4.0)[mask].max() < 1e-10
        lvl_b = Level(h.finest)
        au_b = np.asarray(lvl_b.apply(jnp.asarray(uq)))
        assert np.abs(au_b - 4.0)[mask].max() > 0.1  # bilinear is not exact

    def test_solve_converges_with_quadratic_closure(self):
        from pressurepoissonsolver_tpu.problems import get_problem, init_problem
        from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

        h, _ = self._setup()
        s = PoissonSolver(h, SolveOptions(tol=1e-11, iface_scheme="quadratic"))
        f, exact = init_problem(h.finest, get_problem("trig", 2))
        res = s.solve(jnp.asarray(f))
        rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
        assert rep["residual"] < 1e-10
        assert rep["error"] < 5e-3

    def test_sharded_apply_matches_quadratic(self):
        """The halo engine handles depth-2 face sources."""
        from pressurepoissonsolver_tpu.domain import DomainHierarchy
        from pressurepoissonsolver_tpu.geometry import refined_tree
        from pressurepoissonsolver_tpu.ops.level_ops import Level
        from pressurepoissonsolver_tpu.parallel.halo import ShardedLevel
        from pressurepoissonsolver_tpu.parallel.sharding import make_mesh

        t = refined_tree(2, 3, 1)
        h = DomainHierarchy(t, n=8, num_shards=8)
        lvl = Level(h.finest, iface_scheme="quadratic")
        sl = ShardedLevel(lvl, make_mesh(8))
        rng = np.random.default_rng(2)
        u = rng.standard_normal((lvl.P, 8, 8))
        ref = np.asarray(lvl.apply(jnp.asarray(u)))
        out = np.asarray(sl.apply(jnp.asarray(u)))
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_quadratic_closure_error_decay_vs_bilinear():
    """Solve-level error decay, bilinear vs quadratic
    refinement-boundary closures on the same adaptive mesh family.

    Result: both closures give
    2nd-order *global* error decay on the smooth trig problem — the
    bilinear closure's O(1) truncation lives on a measure-zero interface
    set and is damped to O(h^2) globally — but the quadratic closure is
    consistently ~16% more accurate in the L2 error restricted to
    refinement-boundary rows (0.84x at every divide).  This asserts both
    facts (reference MatrixHelper2d.cpp:30-122 motivation)."""
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    errs = {"bilinear": [], "quadratic": []}
    ref_errs = {"bilinear": [], "quadratic": []}
    for divide in range(3):
        t = refined_tree(2, 3, 1)
        for _ in range(divide):
            t.refine_leaves()
        h = DomainHierarchy(t, n=8)
        f, exact = init_problem(h.finest, get_problem("trig", 2))
        pl = h.finest
        n = 8
        # cells on patch rows adjacent to a refinement-type neighbor
        m = np.zeros((pl.num_patches, n, n), dtype=bool)
        for p in range(pl.num_patches):
            for sd in range(2 * pl.D):
                if pl.nbr_type[p, sd] in (2, 3):
                    a = sd // 2
                    sl = [p, slice(None), slice(None)]
                    sl[1 + (1 - a)] = 0 if sd % 2 == 0 else n - 1
                    m[tuple(sl)] = True
        for scheme in errs:
            s = PoissonSolver(h, SolveOptions(tol=1e-11, iface_scheme=scheme))
            res = s.solve(jnp.asarray(f))
            rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
            assert rep["residual"] < 1e-10
            errs[scheme].append(rep["error"])
            err = np.abs(np.asarray(res.x) - exact)
            ref_errs[scheme].append(float(np.sqrt((err[m] ** 2).mean())))
    # quadratic strictly better on the refinement-boundary rows, every size
    for eb, eq in zip(ref_errs["bilinear"], ref_errs["quadratic"]):
        assert eq < 0.9 * eb, (ref_errs)
    # 2nd-order global decay for both closures across the 4x DOF range
    for scheme in errs:
        order = np.log2(errs[scheme][0] / errs[scheme][2]) / 2
        assert order > 1.8, (errs, order)


def test_f64_refined_patch_solve_identity():
    """The f64 spectral patch solve (exact per-axis DST/DCT factorization)
    satisfies the solve identity ``K u = f - G gamma`` to 1e-10 relative.
    Bound: the factorization's rounding is eps64 (~1e-16) amplified by the
    patch operator's condition number, ~(4/pi^2) n^2 (h_max/h_min)^2 ~ 1e3
    at n=16 on this mesh, times the n-term sums of the transforms — about
    1e-12 in all, so 1e-10 leaves margin for summation order."""
    from pressurepoissonsolver_tpu.geometry import refined_tree

    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=16)
    lvl = Level(h.finest, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    f = jnp.asarray(rng.standard_normal((lvl.P, 16, 16)))
    g = jnp.asarray(rng.standard_normal((lvl.num_ifaces, lvl.m)))
    u = lvl.patch_solve(f, g)
    r = np.asarray(lvl.apply_with_interface(u, g) - f)
    rel = np.abs(r).max() / np.abs(np.asarray(f)).max()
    assert rel < 1e-10, rel
    # and the all-Neumann (DC-pinned) group converges too
    hn = DomainHierarchy(refined_tree(2, 2, 1), n=16, neumann=True)
    ln = Level(hn.finest, dtype=jnp.float64)
    fn = jnp.asarray(rng.standard_normal((ln.P, 16, 16)))
    gn = jnp.asarray(rng.standard_normal((ln.num_ifaces, ln.m)))
    un = ln.patch_solve(fn, gn)
    rn = np.array(ln.apply_with_interface(un, gn) - fn)
    # residual defined up to the pinned constant per all-Neumann patch
    rn -= rn.mean(axis=(1, 2), keepdims=True)
    reln = np.abs(rn).max() / np.abs(np.asarray(fn)).max()
    assert reln < 1e-9, reln
