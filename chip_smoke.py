"""Smoke test of the solver's main path on one NVIDIA GPU.

Run from the root of a checkout::

    python chip_smoke.py            # phases 1-8 on one card
    python chip_smoke.py --multi    # the 4-card halo-sharded solve only

Every phase prints one JSON line (DOF, patches, iterations, residual,
error against the manufactured solution, solve and compile seconds, the
device's peak memory so far, and the precision it ran at).  A phase that
fails raises, so the script exits non-zero and does not print the final
line; the final line is exactly

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

There is no CPU fallback: without a GPU the device check raises before
any solve.  All work runs in this one process, which holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# Bounds, each with its reason.
#: Device solve vs the host's sparse direct solve of the same assembled
#: operator, max-norm relative.  The device solve stops at a relative
#: residual of 1e-10; the error that residual allows is 1e-10 times the
#: operator's condition number (estimated and printed per case), and the
#: residual's dominant modes are the high-frequency ones the operator
#: damps least, so the observed difference sits far below that estimate.
REF_SMALL_TOL = 1e-7
#: Host recheck of the device residual with the f64 CSR operator: the two
#: sum the same terms in another order, so they agree to a few ulps of
#: the summands (|A||u| / |f| is ~1e2 here), not bit for bit.
HOST_RESIDUAL_TOL = 1.5e-10
#: Two solutions of the same system that each reach a 1e-10 residual
#: (IR vs full f64, composite vs Schur), max-norm relative.
AGREE_TOL = 1e-7
#: The fused stencil kernel vs XLA's stencil, f32, max-norm relative to
#: max |A u|: the same terms summed in another order, a few f32 ulps of
#: the largest term (|u| h^-2), which is ~|A u| for a random field.
STENCIL_TOL = 1e-5
#: The 4-card halo-sharded solve vs the one-card solve: same algorithm,
#: other reduction order.
MULTI_TOL = 1e-9

TOL = 1e-10
_T0 = time.perf_counter()
TF32_NOTE = (
    "f32 spectral transforms at default matmul precision (TF32 on the "
    "H100); one-hot transfer/placement matmuls at HIGHEST (exact f32)"
)


def emit(rec: dict) -> None:
    """Print one phase record, stamped with seconds since start."""
    print(json.dumps({**rec, "t": time.perf_counter() - _T0}), flush=True)


def _check(ok: bool, rec) -> None:
    """Fail the phase (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"check failed: {rec}")


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def _timed(fn):
    """``(result, first_s, second_s)``: the first call compiles, the second
    is the solve time.  ``fn`` returns a pytree of device arrays."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    second = time.perf_counter() - t0
    return out, first, second


def _record(phase, pl, solve_s, first_s, **kw) -> dict:
    rec = {
        "phase": phase,
        "dof": int(pl.num_cells),
        "patches": int(pl.real_patches),
        **kw,
        "solve_s": solve_s,
        "compile_s": max(first_s - solve_s, 0.0),
        "peak_bytes_in_use": peak_bytes(),
    }
    return rec


def bench_tree():
    """The 2D bench mesh: ``refined_tree(2, 5, 2)`` plus one uniform
    refinement (1,048 patches at n=64: 4,292,608 DOF)."""
    from pressurepoissonsolver_tpu.geometry import refined_tree

    t = refined_tree(2, 5, 2)
    t.refine_leaves()
    return t


def _problem(h, D):
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.problems import get_problem, init_problem

    f, exact = init_problem(h.finest, get_problem("trig", D))
    return jnp.asarray(f), jnp.asarray(exact)


def _ir_solver(h, mesh=None):
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    return PoissonSolver(
        h, SolveOptions(tol=TOL, precond_dtype=jnp.float32), mesh=mesh
    )


def _solve_ir(solver, f):
    def run():
        u, info = solver.solve_refined(f, tol=TOL, sync=False)
        return u, info["outer_iterations"], info["inner_iterations"]

    (u, outer, inner), first, second = _timed(run)
    return u, int(outer), int(inner), first, second


def _rel_maxdiff(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# -- phases ----------------------------------------------------------------


def phase_device(platform: str = "gpu") -> dict:
    """Raises unless JAX's first device is a ``platform`` device."""
    import jax

    from pressurepoissonsolver_tpu import compile_cache_dir, native
    from pressurepoissonsolver_tpu.utils.profiling import device_info

    rec = {
        "phase": "device",
        **device_info(platform),
        "jax": jax.__version__,
        "compile_cache": jax.config.jax_compilation_cache_dir
        or compile_cache_dir(),
        "native_tablegen": native.available(),
    }
    emit(rec)
    return rec


def phase_reference_small(cases=None) -> list:
    """Device IR solves against the host's sparse direct solve of the
    assembled f64 operator (``matrix.assemble_composite``)."""
    import scipy.sparse.linalg as spla

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.matrix import assemble_composite

    if cases is None:
        cases = ((2, refined_tree(2, 3, 1), 16), (3, refined_tree(3, 2, 1), 8))
    recs = []
    for D, tree, n in cases:
        h = DomainHierarchy(tree, n=n)
        f, exact = _problem(h, D)
        s = _ir_solver(h)
        u, outer, inner, first, second = _solve_ir(s, f)
        rep = s.report(u, f, exact)
        A = assemble_composite(h.finest).tocsc()
        u_ref = spla.spsolve(A, np.asarray(f).ravel())
        lu = spla.splu(A)
        inv = spla.LinearOperator(
            A.shape, matvec=lu.solve, rmatvec=lambda x: lu.solve(x, trans="T"),
            dtype=np.float64,
        )
        cond = float(spla.onenormest(A) * spla.onenormest(inv))
        diff = _rel_maxdiff(np.asarray(u).ravel(), u_ref)
        rec = _record(
            f"reference_small_{D}d", h.finest, second, first,
            outer_iterations=outer, inner_iterations=inner,
            residual=rep["residual"], error=rep["error"],
            vs_spsolve_rel_maxdiff=diff, bound=REF_SMALL_TOL,
            cond1_estimate=cond,
            precision="f64 IR around f32 GMG-BiCGStab; " + TF32_NOTE,
        )
        emit(rec)
        _check(rep["residual"] <= TOL, rec)
        _check(diff <= REF_SMALL_TOL, rec)
        recs.append(rec)
    return recs


def phase_solve2d_ir(h, f, exact):
    """``solve_refined`` to 1e-10 on the bench mesh, residual rechecked on
    the host with the f64 CSR operator."""
    from pressurepoissonsolver_tpu.matrix import assemble_composite

    s = _ir_solver(h)
    u, outer, inner, first, second = _solve_ir(s, f)
    rep = s.report(u, f, exact)
    A = assemble_composite(h.finest)
    fh = np.asarray(f).ravel()
    host_res = float(
        np.linalg.norm(fh - A @ np.asarray(u).ravel()) / np.linalg.norm(fh)
    )
    rec = _record(
        "solve2d_ir", h.finest, second, first,
        outer_iterations=outer, inner_iterations=inner,
        residual=rep["residual"], host_residual=host_res, error=rep["error"],
        precision="f64 IR around f32 GMG-BiCGStab; " + TF32_NOTE,
    )
    emit(rec)
    _check(rep["residual"] <= TOL, rec)
    _check(host_res <= HOST_RESIDUAL_TOL, rec)
    return rec, s, u


def phase_solve2d_f64(h, f, exact, u_ir):
    """Full-f64 GMG-BiCGStab to 1e-10 on the same mesh."""
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    s = PoissonSolver(h, SolveOptions(tol=TOL, precond_dtype=jnp.float64))

    def run():
        res = s.solve(f)
        return res.x, res.iterations

    (u, iters), first, second = _timed(run)
    rep = s.report(u, f, exact)
    diff = _rel_maxdiff(u, u_ir)
    rec = _record(
        "solve2d_f64", h.finest, second, first,
        outer_iterations=int(iters), inner_iterations=0,
        residual=rep["residual"], error=rep["error"],
        vs_ir_rel_maxdiff=diff,
        precision="f64 throughout (f64 matmuls run natively)",
    )
    emit(rec)
    _check(rep["residual"] <= TOL, rec)
    _check(diff <= AGREE_TOL, rec)
    return rec


def phase_schur2d(solver, f, exact, u_ref):
    """``solve_schur`` with the GMG-Woodbury interface preconditioner."""
    def run():
        u, res = solver.solve_schur(f, tol=TOL, preconditioner="gmg")
        return u, res.iterations

    (u, iters), first, second = _timed(run)
    rep = solver.report(u, f, exact)
    diff = _rel_maxdiff(u, u_ref)
    rec = _record(
        "schur2d", solver.hierarchy.finest, second, first,
        outer_iterations=int(iters), inner_iterations=0,
        residual=rep["residual"], error=rep["error"],
        vs_composite_rel_maxdiff=diff,
        precision="f64 interface BiCGStab, f32 GMG-Woodbury preconditioner; "
        + TF32_NOTE,
    )
    emit(rec)
    _check(rep["residual"] <= TOL, rec)
    _check(diff <= AGREE_TOL, rec)
    return rec


def phase_solve3d_ir(tree=None, n: int = 32):
    """``solve_refined`` on a 3D octree (``refined_tree(3, 3, 2)``, n=32:
    78 patches, 2,555,904 DOF)."""
    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree

    tree = refined_tree(3, 3, 2) if tree is None else tree
    h = DomainHierarchy(tree, n=n)
    f, exact = _problem(h, 3)
    s = _ir_solver(h)
    u, outer, inner, first, second = _solve_ir(s, f)
    rep = s.report(u, f, exact)
    rec = _record(
        "solve3d_ir", h.finest, second, first,
        outer_iterations=outer, inner_iterations=inner,
        residual=rep["residual"], error=rep["error"],
        precision="f64 IR around f32 GMG-BiCGStab; " + TF32_NOTE,
    )
    emit(rec)
    _check(rep["residual"] <= TOL, rec)
    return rec


def phase_cli(tree=None, n: int = 32, workdir: str = None):
    """The ``steady2d`` CLI in-process on a mesh file written by
    ``Tree.to_file``."""
    from pressurepoissonsolver_tpu.cli import main
    from pressurepoissonsolver_tpu.geometry import refined_tree

    tree = refined_tree(2, 4, 2) if tree is None else tree
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mesh = os.path.join(tmp, "mesh.bin")
        out_json = os.path.join(tmp, "out.json")
        tree.to_file(mesh)
        t0 = time.perf_counter()
        rc = main(2, ["--mesh", mesh, "-n", str(n), "-t", str(TOL),
                      "--out-json", out_json])
        wall = time.perf_counter() - t0
        _check(rc == 0, rc)
        with open(out_json) as fh:
            rep = json.load(fh)
    rec = {
        "phase": "cli",
        "dof": rep["dof"],
        "outer_iterations": rep["iterations"],
        "inner_iterations": 0,
        "residual": rep["residual"],
        "error": rep["error"],
        "solve_s": rep["linear_solve_s"],
        "compile_s": None,
        "wall_s": wall,
        "peak_bytes_in_use": peak_bytes(),
        "precision": "f64 GMG-BiCGStab (CLI defaults)",
    }
    emit(rec)
    _check(rep["residual"] < TOL, rec)
    return rec


def time_chain(fn, x, inner: int = 10, reps: int = 5) -> float:
    """Seconds per ``fn`` call: ``inner`` chained calls unrolled in one
    jitted program (no device loop, no per-call dispatch; a barrier after
    each call keeps XLA from fusing one call into the next), best of
    ``reps`` runs after a compile run."""
    import jax

    @jax.jit
    def chain(v):
        for _ in range(inner):
            v = jax.lax.optimization_barrier(fn(v))
        return v

    jax.block_until_ready(chain(x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x))
        best = min(best, time.perf_counter() - t0)
    return best / inner


def phase_stencil(tree=None, n: int = 64, inner: int = 10, reps: int = 5):
    """The f32 composite apply (``Level.apply``) at an HBM-bound size (the
    bench mesh plus two more refinements: 16,768 patches, 68,681,728 DOF,
    a 275 MB field), timed against 2 x field bytes / peak bandwidth, with
    XLA's stencil and with the fused kernel (``ops/stencil_gpu.py``)."""
    import jax
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.ops.level_ops import Level
    from pressurepoissonsolver_tpu.utils.profiling import device_peaks

    if tree is None:
        tree = bench_tree()
        tree.refine_leaves()
        tree.refine_leaves()
    h = DomainHierarchy(tree, n=n)
    pl = h.finest
    lvl = Level(pl, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((pl.num_patches,) + pl.ns_shape),
                    dtype=jnp.float32)
    # keep the chained iterate bounded: A scales by ~8/h^2 per call
    scale = jnp.float32(0.125 / float(np.max(1.0 / pl.spacings**2)))
    times, outs = {}, {}
    for name, fused in (("xla", False), ("kernel", True)):
        lvl.fused_stencil = fused
        times[name] = time_chain(lambda v: lvl.apply(v) * scale, u, inner, reps)
        outs[name] = jax.jit(lvl.apply)(u)
    diff = _rel_maxdiff(outs["kernel"], outs["xla"])
    # a scaled copy of the same field: what streaming 2 x field reaches
    t_copy = time_chain(lambda v: v * jnp.float32(0.5), u, inner, reps)
    field = pl.num_cells * 4
    bw = device_peaks()["hbm_bytes_per_s"]
    rec = {
        "phase": "stencil",
        "dof": int(pl.num_cells),
        "patches": int(pl.real_patches),
        "field_bytes": field,
        "apply_xla_s": times["xla"],
        "apply_kernel_s": times["kernel"],
        "hbm_bytes_per_s": bw,
        "xla_roofline_share": 2 * field / bw / times["xla"],
        "kernel_roofline_share": 2 * field / bw / times["kernel"],
        "kernel_vs_xla_rel_maxdiff": diff,
        "copy_s": t_copy,
        "copy_roofline_share": 2 * field / bw / t_copy,
        "peak_bytes_in_use": peak_bytes(),
        "precision": "f32 elementwise stencil (no matmul)",
    }
    emit(rec)
    _check(all(np.isfinite(t) and t > 0 for t in times.values()), rec)
    _check(diff <= STENCIL_TOL, rec)
    return rec


def phase_multi(tree=None, n: int = 64, ndev: int = 4):
    """The halo-sharded solve over ``ndev`` cards against the one-card
    solve of the same tree."""
    import jax

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.parallel.sharding import make_mesh

    if len(jax.devices()) < ndev:
        raise RuntimeError(f"--multi needs {ndev} devices, JAX found "
                           f"{len(jax.devices())}")
    tree = bench_tree() if tree is None else tree
    h1 = DomainHierarchy(tree, n=n)
    f1, exact1 = _problem(h1, 2)
    s1 = _ir_solver(h1)
    u1, o1, i1, first1, second1 = _solve_ir(s1, f1)

    mesh = make_mesh(ndev)
    hs = DomainHierarchy(tree, n=n, num_shards=ndev)
    fs, exacts = _problem(hs, 2)
    ss = _ir_solver(hs, mesh=mesh)  # comm "auto" = the halo engine
    us, outer, inner, first, second = _solve_ir(ss, fs)
    rep = ss.report(us, ss._device_put(fs), ss._device_put(exacts))
    nr = hs.finest.real_patches
    pos = np.searchsorted(h1.finest.ids, hs.finest.ids[:nr])
    diff = _rel_maxdiff(np.asarray(us)[:nr], np.asarray(u1)[pos])
    devices = len(us.sharding.device_set)
    rec = _record(
        "multi", hs.finest, second, first,
        outer_iterations=outer, inner_iterations=inner,
        residual=rep["residual"], error=rep["error"],
        devices=devices, one_card_solve_s=second1,
        one_card_iterations=[o1, i1], vs_one_card_rel_maxdiff=diff,
        precision="f64 IR around f32 GMG-BiCGStab, halo engine; " + TF32_NOTE,
    )
    emit(rec)
    _check(devices == ndev, rec)
    _check(rep["residual"] <= TOL, rec)
    _check(diff <= MULTI_TOL, rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card halo-sharded solve and the "
                    "one-card solve it is compared with")
    args = ap.parse_args(argv)

    import jax

    from pressurepoissonsolver_tpu.utils.profiling import nvidia_smi

    dev = jax.devices()[0]
    phase_device()
    print(nvidia_smi(), flush=True)
    if args.multi:
        phase_multi()
    else:
        from pressurepoissonsolver_tpu.domain import DomainHierarchy

        phase_reference_small()
        h = DomainHierarchy(bench_tree(), n=64)
        f, exact = _problem(h, 2)
        _, s_ir, u_ir = phase_solve2d_ir(h, f, exact)
        phase_solve2d_f64(h, f, exact, u_ir)
        phase_schur2d(s_ir, f, exact, u_ir)
        del s_ir, u_ir, h, f, exact
        phase_solve3d_ir()
        phase_cli()
        phase_stencil()
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
