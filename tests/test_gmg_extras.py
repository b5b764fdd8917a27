"""GMG transfer-operator tests (ports the intents of the reference's
disabled ``test/GMG.cpp`` AvgRstr/DrctIntp/TriLinIntp behavior tests)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import refined_tree, uniform_tree
from pressurepoissonsolver_tpu.gmg import CycleOpts, Transfer, _linear_prolong_matrix
from pressurepoissonsolver_tpu.ops.level_ops import Level
from pressurepoissonsolver_tpu.problems import get_problem, init_problem
from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions


def _levels(adaptive=False, n=4):
    t = refined_tree(2, 2, 1) if adaptive else uniform_tree(2, 2)
    h = DomainHierarchy(t, n=n)
    return h, Level(h[0]), Level(h[1])


@pytest.mark.parametrize("adaptive", [False, True])
def test_restrict_preserves_constant_and_integral(adaptive):
    h, fine, coarse = _levels(adaptive)
    tr = Transfer(fine, coarse)
    ones = jnp.ones((fine.P,) + fine.pl.ns_shape)
    c = tr.restrict(ones)
    np.testing.assert_allclose(np.asarray(c), 1.0, rtol=1e-14)
    # cell-average restriction preserves the volume integral
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((fine.P,) + fine.pl.ns_shape))
    np.testing.assert_allclose(
        float(coarse.integrate(tr.restrict(v))), float(fine.integrate(v)), rtol=1e-12
    )


@pytest.mark.parametrize("mode", ["constant", "linear"])
def test_prolong_preserves_constant(mode):
    h, fine, coarse = _levels(adaptive=True)
    tr = Transfer(fine, coarse, prolong_mode=mode)
    ones_c = jnp.ones((coarse.P,) + coarse.pl.ns_shape)
    out = tr.prolong_add(ones_c, fine.zeros())
    np.testing.assert_allclose(np.asarray(out), 1.0, rtol=1e-14)


def test_linear_prolong_exact_for_linear_fields():
    """Bi-linear prolongation reproduces linear functions exactly
    (including the one-sided extrapolation rows at patch edges)."""
    h, fine, coarse = _levels(adaptive=False, n=8)
    tr = Transfer(fine, coarse, prolong_mode="linear")
    cc = coarse.pl.cell_centers()  # [Pc, n, n, 2]
    lin_c = jnp.asarray(2.0 * cc[..., 0] - 3.0 * cc[..., 1] + 0.5)
    fc = fine.pl.cell_centers()
    lin_f = 2.0 * fc[..., 0] - 3.0 * fc[..., 1] + 0.5
    out = tr.prolong_add(lin_c, fine.zeros())
    np.testing.assert_allclose(np.asarray(out), lin_f, rtol=1e-12, atol=1e-12)


def test_linear_prolong_matrix_rows_sum_to_one():
    for n in (4, 8, 16):
        for h in (0, 1):
            W = _linear_prolong_matrix(n, h)
            np.testing.assert_allclose(W.sum(axis=1), 1.0, rtol=1e-14)


def test_wcycle_and_linear_interpolator_converge():
    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=8)
    for opts in (
        CycleOpts(cycle_type="W"),
        CycleOpts(interpolator="linear"),
        CycleOpts(pre_sweeps=2, post_sweeps=2),
    ):
        s = PoissonSolver(h, SolveOptions(tol=1e-11, gmg=opts))
        f, exact = init_problem(h.finest, get_problem("trig", 2))
        res = s.solve(jnp.asarray(f))
        rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
        assert rep["residual"] < 1e-10, (opts, rep)
        assert int(res.iterations) < 25


def test_3d_transfers_preserve_constant_and_integral():
    """Matmul-form transfers in 3D: restriction preserves integrals,
    prolongation preserves constants (incl. pass-through patches)."""
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.gmg import Transfer
    from pressurepoissonsolver_tpu.ops.level_ops import Level

    t = refined_tree(3, 2, 1)
    h = DomainHierarchy(t, n=4)
    fine, coarse = Level(h[0]), Level(h[1])
    for mode in ("constant", "linear"):
        tr = Transfer(fine, coarse, prolong_mode=mode)
        ones_c = jnp.ones((coarse.P,) + h[1].ns_shape)
        zf = jnp.zeros((fine.P,) + h[0].ns_shape)
        up = np.asarray(tr.prolong_add(ones_c, zf))
        np.testing.assert_allclose(up, 1.0, rtol=1e-13)
        rng = np.random.default_rng(0)
        uf = jnp.asarray(rng.standard_normal((fine.P,) + h[0].ns_shape))
        rc = tr.restrict(uf)
        np.testing.assert_allclose(
            float(coarse.integrate(rc)), float(fine.integrate(uf)), rtol=1e-12
        )


# ---- FAC active-set relaxation ---------------------------------------------


def test_active_smoother_matches_masked_full_sweep():
    """ActiveSmoother (subset-compute) == Level.smooth masked to the
    active set, exactly — the reduced interface pipeline and subset
    spectral solves must reproduce the full ops patch-for-patch."""
    from pressurepoissonsolver_tpu.gmg import _fac_active_mask
    from pressurepoissonsolver_tpu.ops.level_ops import ActiveSmoother

    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=8)
    fine, coarse = Level(h[0]), Level(h[1])
    tr = Transfer(fine, coarse)
    mask = _fac_active_mask(tr, ring=1)
    assert mask is not None and 0 < mask.sum() < coarse.P
    asm = ActiveSmoother(coarse, mask)

    rng = np.random.default_rng(3)
    f = jnp.asarray(rng.standard_normal((coarse.P,) + coarse.pl.ns_shape))
    u = jnp.asarray(rng.standard_normal((coarse.P,) + coarse.pl.ns_shape))

    full = np.asarray(coarse.smooth(f, u))
    got = np.asarray(asm.smooth(f, u))
    np.testing.assert_allclose(got[mask], full[mask], rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(got[~mask], np.asarray(u)[~mask])

    full0 = np.asarray(coarse.smooth_zero(f))
    got0 = np.asarray(asm.smooth_zero(f))
    np.testing.assert_allclose(got0[mask], full0[mask], rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(got0[~mask], 0.0)


def test_fac_active_solve_converges_like_full():
    """The FAC active-set cycle preconditions as well as relax-everywhere:
    same iteration count on an adaptive solve."""
    t = refined_tree(2, 4, 2)
    h = DomainHierarchy(t, n=8)
    f_np, exact = init_problem(h.finest, get_problem("trig", 2))
    iters = {}
    for mode in ("full", "active"):
        opts = SolveOptions(
            tol=1e-10,
            gmg=CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing=mode),
        )
        s = PoissonSolver(h, opts)
        res = s.solve(jnp.asarray(f_np), max_iter=60)
        iters[mode] = int(res.iterations)
        assert iters[mode] < 60
        rep = s.report(res.x, jnp.asarray(f_np), jnp.asarray(exact))
        assert rep["residual"] < 1e-9
    assert iters["active"] <= iters["full"] + 2
