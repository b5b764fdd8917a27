"""End-to-end manufactured-solution solves — the primary integration gate
(reference behavior: ``apps/2d/steady.cpp``, converged relative residual
~1e-10..1e-12 and 2nd-order discretization error; SURVEY.md §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import Tree, refined_tree, uniform_tree
from pressurepoissonsolver_tpu.gmg import CycleOpts
from pressurepoissonsolver_tpu.problems import get_problem, init_problem
from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions, shift_for_neumann


def _solve(D, levels, n, problem="trig", neumann=False, adaptive=False,
           tol=1e-11, precondition=True):
    t = refined_tree(D, levels, 1) if adaptive else uniform_tree(D, levels)
    h = DomainHierarchy(t, n=n, neumann=neumann)
    s = PoissonSolver(h, SolveOptions(tol=tol, precondition=precondition))
    prob = get_problem(problem, D)
    f, exact = init_problem(h.finest, prob, neumann=neumann)
    f = jnp.asarray(f)
    if neumann:
        f = shift_for_neumann(s.fine_level, f)
    res = s.solve(f)
    rep = s.report(res.x, f, jnp.asarray(exact), neumann=neumann)
    return res, rep


def test_2d_dirichlet_solve_to_tolerance():
    res, rep = _solve(2, levels=3, n=8)
    assert rep["residual"] < 1e-10
    assert int(res.iterations) < 30
    # discretization error for 32x32 cells, trig problem
    assert rep["error"] < 2e-2


def test_2d_dirichlet_second_order():
    _, rep1 = _solve(2, levels=3, n=8)  # h = 1/32
    _, rep2 = _solve(2, levels=4, n=8)  # h = 1/64
    ratio = rep1["error"] / rep2["error"]
    assert 3.0 < ratio < 5.0, ratio


def _solve_mixed(D, levels, n, sides, adaptive=False):
    """Mixed Dirichlet/Neumann walls (per-side IsNeumannFunc parity,
    ``PatchInfo.h:684-697``): the named walls are Neumann, the rest
    Dirichlet; BC folding derives per patch side from the level tables."""
    t = refined_tree(D, levels, 1) if adaptive else uniform_tree(D, levels)
    h = DomainHierarchy(t, n=n, neumann=sides)
    s = PoissonSolver(h, SolveOptions(tol=1e-11))
    f, exact = init_problem(h.finest, get_problem("trig", D))
    f = jnp.asarray(f)
    res = s.solve(f)
    rep = s.report(res.x, f, jnp.asarray(exact))
    return res, rep


def test_mixed_bc_2d_second_order():
    _, rep1 = _solve_mixed(2, 3, 8, ["x_lo", "y_hi"])
    _, rep2 = _solve_mixed(2, 4, 8, ["x_lo", "y_hi"])
    assert rep1["residual"] < 1e-10
    assert rep2["residual"] < 1e-10
    ratio = rep1["error"] / rep2["error"]
    assert 3.0 < ratio < 5.0, ratio


def test_mixed_bc_2d_adaptive():
    _, rep = _solve_mixed(2, 3, 8, ["y_lo"], adaptive=True)
    assert rep["residual"] < 1e-10
    assert rep["error"] < 3e-2


def test_mixed_bc_3d_second_order():
    _, rep1 = _solve_mixed(3, 2, 8, ["z_lo", "x_hi"])
    _, rep2 = _solve_mixed(3, 3, 8, ["z_lo", "x_hi"])
    assert rep1["residual"] < 1e-10
    ratio = rep1["error"] / rep2["error"]
    assert 3.0 < ratio < 5.0, ratio


def test_mixed_bc_callable_matches_sides():
    """The IsNeumannFunc-style callable spec and the side-name spec build
    identical levels (and the python builder agrees with the native
    post-fix path)."""
    t = refined_tree(2, 3, 1)
    h_names = DomainHierarchy(t, n=4, neumann=["x_lo", "y_hi"])
    h_call = DomainHierarchy(
        t, n=4, neumann=lambda s, starts, lengths: s in (0, 3),
        use_native=False,
    )
    h_py = DomainHierarchy(t, n=4, neumann=["x_lo", "y_hi"], use_native=False)
    for a, b in ((h_names, h_call), (h_names, h_py)):
        for la, lb in zip(a.levels, b.levels):
            np.testing.assert_array_equal(la.neumann, lb.neumann)
    assert h_names.finest.neumann.any()
    assert not h_names.finest.neumann.all()


def test_patch_granularity_invariance():
    """Cutting the same composite grid into 4x fewer, 2x bigger patches
    leaves the discretization identical: same-level interfaces are exact
    halos (ghost = u_nbr), so only patch-boundary PLACEMENT changes, not
    the assembled operator.  This is the property that lets the solver
    choose its patch granularity for device efficiency (wider face rows,
    fewer gather rows) independently of the reference's n=16 convention."""
    t16 = refined_tree(2, 3, 2)
    t16.refine_leaves()
    t32 = refined_tree(2, 3, 2)
    errs = []
    for (t, n) in ((t16, 8), (t32, 16)):
        h = DomainHierarchy(t, n=n)
        s = PoissonSolver(h, SolveOptions(tol=1e-11))
        f, exact = init_problem(h.finest, get_problem("trig", 2))
        f = jnp.asarray(f)
        res = s.solve(f)
        rep = s.report(res.x, f, jnp.asarray(exact))
        assert rep["residual"] < 1e-10
        errs.append(rep["error"])
    assert abs(errs[0] - errs[1]) < 1e-9 * abs(errs[0])


def test_patch_granularity_invariance_3d():
    """3D variant: n=16/divide-0 is the identical composite grid as
    n=8/divide-1 (each once-refined leaf's 8 children of 8^3 cells tile
    the parent's 16^3) — the basis for the n=32 cutting of the 3D bench
    mesh (scripts/bench3d.py)."""
    t8 = refined_tree(3, 2, 1)
    t8.refine_leaves()
    t16 = refined_tree(3, 2, 1)
    errs = []
    for (t, n) in ((t8, 8), (t16, 16)):
        h = DomainHierarchy(t, n=n)
        s = PoissonSolver(h, SolveOptions(tol=1e-11))
        f, exact = init_problem(h.finest, get_problem("trig", 3))
        f = jnp.asarray(f)
        res = s.solve(f)
        rep = s.report(res.x, f, jnp.asarray(exact))
        assert rep["residual"] < 1e-10
        errs.append(rep["error"])
    # identical discretization; the match is limited by the 1e-11 solver
    # tolerance (measured 1.2e-9 relative), not the grids
    assert abs(errs[0] - errs[1]) < 1e-8 * abs(errs[0])


def test_2d_neumann_solve():
    res, rep = _solve(2, levels=3, n=8, neumann=True)
    assert rep["residual"] < 1e-9
    assert rep["error"] < 3e-2
    assert abs(rep["conservation"]) < 1e-10


def test_2d_adaptive_solve():
    res, rep = _solve(2, levels=3, n=8, adaptive=True)
    assert rep["residual"] < 1e-10
    assert rep["error"] < 2e-2


def test_2d_unpreconditioned_matches_gmg():
    res_a, rep_a = _solve(2, levels=2, n=8, precondition=True)
    res_b, rep_b = _solve(2, levels=2, n=8, precondition=False, tol=1e-12)
    assert rep_a["residual"] < 1e-10 and rep_b["residual"] < 1e-10
    # GMG should cut iteration count substantially
    assert int(res_a.iterations) <= int(res_b.iterations)


def test_gmg_iterations_mesh_independent():
    """The algorithmic-quality bar (BASELINE.md): iteration counts should be
    nearly mesh-independent with the GMG preconditioner."""
    its = []
    for levels in (5, 6, 7, 8):  # 16k ... 1.05M DOF — above the direct-coarse cap
        res, rep = _solve(2, levels=levels, n=8)
        assert rep["residual"] < 1e-10
        its.append(int(res.iterations))
    # reference quality bar: 15-19 iters over a 64x DOF range (BASELINE.md);
    # require a spread of at most 2 over the same 64x range here
    assert max(its) <= min(its) + 2, its


def test_3d_dirichlet_solve():
    res, rep = _solve(3, levels=2, n=8)
    assert rep["residual"] < 1e-10
    assert rep["error"] < 2e-2


def test_3d_second_order():
    _, rep1 = _solve(3, levels=2, n=4)  # h = 1/8
    _, rep2 = _solve(3, levels=2, n=8)  # h = 1/16
    ratio = rep1["error"] / rep2["error"]
    assert 2.5 < ratio < 6.0, ratio


#: uniform octrees standing in for the reference's 2uni/3uni/4uni fixtures
UNI_LEVELS = {"2uni": 2, "3uni": 3, "4uni": 4}


@pytest.mark.parametrize(
    "mesh,n",
    [("2uni", 8), ("3uni", 8), ("4uni", 4)],
)
def test_3d_reference_uniform_meshes(mesh, n):
    """Converged solutions on uniform octrees of the reference fixtures'
    shapes to <1e-10 (BASELINE 'match converged solutions on
    2uni/2refine/3uni/4uni')."""
    t = uniform_tree(3, UNI_LEVELS[mesh])
    h = DomainHierarchy(t, n=n)
    s = PoissonSolver(h, SolveOptions(tol=1e-11))
    prob = get_problem("trig", 3)
    f, exact = init_problem(h.finest, prob)
    res = s.solve(jnp.asarray(f))
    rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
    assert rep["residual"] < 1e-10
    assert rep["error"] < 5e-2
    assert abs(rep["conservation"]) < 1e-7


def test_3d_second_order_on_reference_meshes():
    """Error halves quadratically from 3uni to 4uni at fixed n."""
    errs = []
    for mesh in ("3uni", "4uni"):
        t = uniform_tree(3, UNI_LEVELS[mesh])
        h = DomainHierarchy(t, n=4)
        s = PoissonSolver(h, SolveOptions(tol=1e-11))
        f, exact = init_problem(h.finest, get_problem("trig", 3))
        res = s.solve(jnp.asarray(f))
        rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
        assert rep["residual"] < 1e-10
        errs.append(rep["error"])
    ratio = errs[0] / errs[1]
    assert 3.0 < ratio < 5.0, ratio


def test_3d_reference_mesh_2refine():
    t = refined_tree(3, 2, 1)  # stand-in for the reference's 2refine
    h = DomainHierarchy(t, n=4)
    s = PoissonSolver(h, SolveOptions(tol=1e-11))
    prob = get_problem("trig", 3)
    f, exact = init_problem(h.finest, prob)
    res = s.solve(jnp.asarray(f))
    rep = s.report(res.x, jnp.asarray(f), jnp.asarray(exact))
    assert rep["residual"] < 1e-10
    assert rep["error"] < 0.2  # coarse mesh; just sanity


def test_schur_matches_composite():
    t = uniform_tree(2, 3)
    h = DomainHierarchy(t, n=8)
    s = PoissonSolver(h, SolveOptions(tol=1e-12))
    prob = get_problem("trig", 2)
    f, exact = init_problem(h.finest, prob)
    f = jnp.asarray(f)
    res = s.solve(f)
    u_schur, schur_res = s.solve_schur(f)
    err = float(jnp.abs(u_schur - res.x).max() / jnp.abs(res.x).max())
    assert err < 1e-8, err
    rep = s.report(u_schur, f, jnp.asarray(exact))
    assert rep["residual"] < 1e-9


def test_iterative_refinement_reaches_tolerance():
    """Mixed-precision IR: f32 inner solves, f64 outer residual, 1e-10."""
    import jax.numpy as jnp
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    t = uniform_tree(2, 4)
    h = DomainHierarchy(t, n=8)
    s = PoissonSolver(h, SolveOptions(tol=1e-10, precond_dtype=jnp.float32))
    prob = get_problem("trig", 2)
    f, exact = init_problem(h.finest, prob)
    u, info = s.solve_refined(jnp.asarray(f), tol=1e-10)
    assert info["residual"] < 1e-10, info
    assert info["outer_iterations"] <= 8
    rep = s.report(u, jnp.asarray(f), jnp.asarray(exact))
    assert rep["error"] < 2e-2


def test_solver_option_variants():
    """cg Krylov, Schwarz preconditioner, bcgs patch solver all converge."""
    t = uniform_tree(2, 3)
    h = DomainHierarchy(t, n=8)
    prob = get_problem("trig", 2)
    f, exact = init_problem(h.finest, prob)
    f = jnp.asarray(f)
    for kw in (
        dict(krylov="cg"),
        dict(preconditioner="schwarz"),
        dict(patch_solver="bcgs"),
    ):
        s = PoissonSolver(h, SolveOptions(tol=1e-10, **kw))
        res = s.solve(f)
        rep = s.report(res.x, f, jnp.asarray(exact))
        assert rep["residual"] < 1e-9, (kw, rep)


def test_schur_preconditioner_variants():
    t = uniform_tree(2, 3)
    h = DomainHierarchy(t, n=8)
    prob = get_problem("trig", 2)
    f, exact = init_problem(h.finest, prob)
    f = jnp.asarray(f)
    s = PoissonSolver(h, SolveOptions(tol=1e-11))
    its = {}
    for prec in (None, "cheb", "blockjacobi"):
        u, res = s.solve_schur(f, preconditioner=prec)
        rep = s.report(u, f, jnp.asarray(exact))
        assert rep["residual"] < 1e-9, (prec, rep)
        its[prec] = int(res.iterations)
    assert its["blockjacobi"] <= its[None] + 2


def test_gmres_krylov_random_system():
    from pressurepoissonsolver_tpu.krylov import gmres

    rng = np.random.default_rng(3)
    N = 40
    Amat = np.eye(N) + 0.1 * rng.standard_normal((N, N))
    b = rng.standard_normal(N)
    res = gmres(lambda v: jnp.asarray(Amat) @ v, jnp.asarray(b),
                tol=1e-12, restart=15, max_iter=200)
    x = np.asarray(res.x)
    assert np.linalg.norm(Amat @ x - b) / np.linalg.norm(b) < 1e-10
    assert int(res.iterations) > 0


def test_gmres_with_preconditioner_matches_direct():
    from pressurepoissonsolver_tpu.krylov import gmres

    rng = np.random.default_rng(4)
    N = 30
    Amat = np.diag(np.linspace(1.0, 50.0, N)) + 0.5 * rng.standard_normal((N, N))
    Minv = np.diag(1.0 / np.diag(Amat))
    b = rng.standard_normal(N)
    res = gmres(
        lambda v: jnp.asarray(Amat) @ v,
        jnp.asarray(b),
        M=lambda v: jnp.asarray(Minv) @ v,
        tol=1e-12,
        restart=10,
        max_iter=300,
    )
    expected = np.linalg.solve(Amat, b)
    assert np.allclose(np.asarray(res.x), expected, atol=1e-8)


def test_gmres_composite_solve_and_schur():
    # gmres as the outer Krylov method on the composite operator...
    tree = refined_tree(2, 2, 1)
    hierarchy = DomainHierarchy(tree, n=8)
    opts = SolveOptions(tol=1e-10, krylov="gmres")
    solver = PoissonSolver(hierarchy, opts)
    f, exact = init_problem(hierarchy.finest, get_problem("trig", 2))
    f = jnp.asarray(f)
    res = solver.solve(f, max_iter=300)
    rep = solver.report(res.x, f, jnp.asarray(exact))
    assert rep["residual"] < 1e-9
    # ...and matrix-free GMRES on the Schur interface system (the BASELINE
    # "Schur-complement interface system, matrix-free GMRES" config)
    u_s, res_s = solver.solve_schur(f)
    rep_s = solver.report(u_s, f, jnp.asarray(exact))
    assert rep_s["residual"] < 1e-8
    assert np.allclose(np.asarray(u_s), np.asarray(res.x), atol=1e-7)
