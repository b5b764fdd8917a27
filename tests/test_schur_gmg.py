"""Schur-GMG interface preconditioner (Woodbury ``(I-S)^-1 = I - Γ A⁻¹ G``)
and the monitored-solve observability surface.

The quality bar is the reference's hypre-preconditioned Schur solve:
15-19 iterations nearly mesh-independent from 2.1M to 136M DOF
(BASELINE.md, ``misc/results/2D_Poisson_Solver_Timing_4_mesh.ipynb``)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import refined_tree, uniform_tree
from pressurepoissonsolver_tpu.problems import get_problem, init_problem
from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions


def _schur_solve(divide: int, prec, n=8, tol=1e-10):
    t = refined_tree(2, 3, 1)
    for _ in range(divide):
        t.refine_leaves()
    h = DomainHierarchy(t, n=n)
    s = PoissonSolver(h, SolveOptions(tol=tol))
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    f = jnp.asarray(f)
    u, res = s.solve_schur(f, preconditioner=prec, max_iter=500)
    rep = s.report(u, f, jnp.asarray(exact))
    return int(res.iterations), rep


def test_schur_gmg_iterations_mesh_independent():
    """Iterations flat (±3) over a 16x DOF sweep.

    Without an AMG-class preconditioner the interface iterations grow
    ~O(1/h) (613 unpreconditioned / 385 block-Jacobi at 655k DOF)."""
    iters = []
    for divide in (1, 2, 3):  # 64x DOF span (measured: 5, 6, 6)
        it, rep = _schur_solve(divide, "gmg")
        assert rep["residual"] < 1e-9, (divide, rep)
        iters.append(it)
    assert max(iters) - min(iters) <= 3, iters
    # comfortably beats the reference's 15-19
    assert max(iters) <= 15, iters


def test_schur_gmg_beats_block_jacobi():
    it_gmg, _ = _schur_solve(1, "gmg")
    it_bj, _ = _schur_solve(1, "blockjacobi")
    assert it_gmg < it_bj


def test_schur_gmg_adaptive_error_second_order():
    _, rep1 = _schur_solve(0, "gmg")
    _, rep2 = _schur_solve(1, "gmg")
    ratio = rep1["error"] / rep2["error"]
    assert 3.0 < ratio < 5.0, ratio


def test_schur_gmg_sharded_halo():
    """The Woodbury preconditioner through the cut-face halo engine on an
    8-device mesh matches the single-device answer."""
    import jax

    from pressurepoissonsolver_tpu.parallel.sharding import make_mesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    t = refined_tree(2, 3, 1)
    h1 = DomainHierarchy(t, n=8)
    s1 = PoissonSolver(h1, SolveOptions(tol=1e-10))
    f1, _ = init_problem(h1.finest, get_problem("trig", 2))
    u1, res1 = s1.solve_schur(jnp.asarray(f1), preconditioner="gmg", max_iter=200)

    mesh = make_mesh(8)
    h8 = DomainHierarchy(t, n=8, num_shards=8)
    s8 = PoissonSolver(h8, SolveOptions(tol=1e-10, comm="halo"), mesh=mesh)
    f8, _ = init_problem(h8.finest, get_problem("trig", 2))
    u8, res8 = s8.solve_schur(jnp.asarray(f8), preconditioner="gmg", max_iter=200)

    # same patches up to the Morton permutation + padding: compare reports
    rep1 = s1.report(u1, jnp.asarray(f1), jnp.asarray(u1))
    rep8 = s8.report(u8, jnp.asarray(f8), jnp.asarray(u8))
    assert rep1["residual"] < 1e-9
    assert rep8["residual"] < 1e-9
    assert abs(int(res1.iterations) - int(res8.iterations)) <= 2


def test_monitored_solve_history():
    """--monitor surface: per-iteration relative residuals reach the
    tolerance and shrink overall."""
    t = uniform_tree(2, 3)
    h = DomainHierarchy(t, n=8)
    s = PoissonSolver(h, SolveOptions(tol=1e-10))
    f, _ = init_problem(h.finest, get_problem("trig", 2))
    u, res, hist = s.solve_monitored(jnp.asarray(f), tol=1e-10, max_iter=60)
    assert hist[0] == pytest.approx(1.0)
    assert hist[-1] <= 1e-10
    assert len(hist) == int(res.iterations) + 1
    # overall contraction (BiCGStab is not strictly monotone per step)
    assert hist[-1] < 1e-8 * hist[0]
    rep = s.report(u, jnp.asarray(f), jnp.asarray(u))
    assert rep["residual"] < 1e-9


def test_monitored_schur_gmg_history():
    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=8)
    s = PoissonSolver(h, SolveOptions(tol=1e-10))
    f, _ = init_problem(h.finest, get_problem("trig", 2))
    u, res, hist = s.solve_monitored(
        jnp.asarray(f), tol=1e-10, max_iter=40, schur=True,
        schur_preconditioner="gmg",
    )
    assert hist[-1] <= 1e-10
    assert int(res.iterations) <= 15


# ---- Schur path under Neumann BCs --------------------------------------------
# The reference composes --schur with --neumann (apps/3d/steady.cpp:330-342
# mean-shift + :336-441 Schur branch; all-Neumann patch solves pin the DC
# mode, FftwPatchSolver.h:197).  The interface system (I - S) inherits the
# constant nullspace on all-Neumann domains; with a zero-mean f it is
# consistent and the Krylov iterate converges to a solution modulo the
# constant, exactly like the composite path.


def _neumann_schur(tree, prec, neumann=True, num_shards=1, mesh=None,
                   tol=1e-10):
    from pressurepoissonsolver_tpu.solver import shift_for_neumann

    h = DomainHierarchy(tree, n=8, neumann=neumann, num_shards=num_shards)
    s = PoissonSolver(h, SolveOptions(tol=tol), mesh=mesh)
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    f = jnp.asarray(f)
    if neumann is True:
        f = shift_for_neumann(s.fine_level, f)
    u, res = s.solve_schur(f, tol=tol, max_iter=300, preconditioner=prec)
    rep = s.report(u, f, jnp.asarray(exact), neumann=(neumann is True))
    return int(res.iterations), rep


def test_schur_neumann_uniform_and_adaptive():
    for tree in (uniform_tree(2, 3), refined_tree(2, 3, 1)):
        it, rep = _neumann_schur(tree, None)
        assert rep["residual"] < 1e-9, rep
        assert rep["error"] < 5e-3, rep
        it_g, rep_g = _neumann_schur(tree, "gmg")
        assert rep_g["residual"] < 1e-9, rep_g
        assert it_g <= it, (it_g, it)


def test_schur_neumann_mixed_walls():
    """Per-side Neumann (IsNeumannFunc parity) through the Schur path: no
    nullspace when at least one wall is Dirichlet."""
    it, rep = _neumann_schur(refined_tree(2, 3, 1), "gmg",
                             neumann=["x_lo", "y_hi"])
    assert rep["residual"] < 1e-9, rep
    assert rep["error"] < 5e-3, rep


def test_schur_neumann_sharded():
    """All-Neumann Schur over the 8-device halo engine; also regression-
    tests the padded-slot masking in ``report`` (the constant-nullspace
    shift used to leak into padding slots and blow up the error metric)."""
    from pressurepoissonsolver_tpu.parallel.sharding import make_mesh

    it, rep = _neumann_schur(
        refined_tree(2, 3, 1), "gmg", num_shards=8, mesh=make_mesh(8)
    )
    assert rep["residual"] < 1e-9, rep
    assert rep["error"] < 5e-3, rep


def test_cli_schur_neumann(tmp_path):
    import json

    from pressurepoissonsolver_tpu.cli import main

    out = tmp_path / "sn.json"
    rc = main(2, ["--uniform", "3", "-n", "8", "--schur", "--neumann",
                  "--prec", "GMG", "-t", "1e-10", "--out-json", str(out)])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["residual"] < 1e-9
    assert rep["error"] < 5e-3
