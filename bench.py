"""Benchmark: 2D adaptive Poisson complete solve on one GPU.

Headline metric (BASELINE.md): DOF/s for a complete solve (GMG-
preconditioned Krylov to 1e-10 relative residual) of a 2D multi-level
adaptive problem — the reference's strongest comparable 1-core number is
the Schur+hypre complete solve: 2,129,920 DOF in 6.37 s = 3.34e5 DOF/s
(``misc/results/2D_Poisson_Solver_Timing_4_mesh.ipynb`` cell 19).

``vs_baseline`` is the ratio to that 1-core CPU baseline; the mesh here is
an in-repo stand-in (``refined_tree(2, 5, 2)`` refined ``PPS_BENCH_DIVIDE``
times), not the reference's, so the ratio is not like for like.

Refuses to run without a GPU; the output names the device (platform,
``device_kind``, count, nvidia-smi name and power limit).

Environment knobs:
  PPS_BENCH_DIVIDE  extra uniform refinements of the mesh (default 1:
                    1,048 patches, 4,292,608 DOF at n=64)
  PPS_BENCH_N       cells per patch side (default 64)
  PPS_BENCH_DTYPE   ir | float64 | float32 (default ir: f64 iterative
                    refinement around f32 Krylov + GMG)
"""

import json
import os
import time


def main():
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.gmg import CycleOpts
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions
    from pressurepoissonsolver_tpu.utils.profiling import device_info

    device = device_info("gpu")
    # n=64 patches: the same composite grid as smaller patches (identical
    # discretization and error — same-level interfaces are exact halos;
    # tests/test_solve.py::test_patch_granularity_invariance), with fewer,
    # wider gather rows
    divide = int(os.environ.get("PPS_BENCH_DIVIDE", "1"))
    n = int(os.environ.get("PPS_BENCH_N", "64"))
    dtype_name = os.environ.get("PPS_BENCH_DTYPE", "ir")

    tree = refined_tree(2, 5, 2)
    for _ in range(divide):
        tree.refine_leaves()

    t_setup0 = time.time()
    hierarchy = DomainHierarchy(tree, n=n)
    dof = hierarchy.finest.num_cells

    # V(2,1) default: fewer inner iterations than V(1,1) for a somewhat
    # costlier cycle
    gmg_opts = CycleOpts(
        pre_sweeps=int(os.environ.get("PPS_BENCH_PRE", "2")),
        post_sweeps=int(os.environ.get("PPS_BENCH_POST", "1")),
        cycle_type=os.environ.get("PPS_BENCH_CYCLE", "V"),
        coarse_direct_max_dof=int(os.environ.get("PPS_BENCH_COARSE_DOF", "4096")),
        max_levels=int(os.environ.get("PPS_BENCH_MAX_LEVELS", "0")),
        coarse_sweeps=int(os.environ.get("PPS_BENCH_COARSE_SWEEPS", "1")),
        # FAC active-set relaxation: only the newly-coarsened region of
        # each coarse level is smoothed (iteration counts unchanged);
        # "full" reproduces the reference's relax-everywhere behavior
        fac_smoothing=os.environ.get("PPS_BENCH_FAC", "active"),
        fac_active_ring=int(os.environ.get("PPS_BENCH_FAC_RING", "1")),
        coarse_pre_sweeps=int(os.environ.get("PPS_BENCH_COARSE_PRE", "0")),
    )
    inner = os.environ.get("PPS_BENCH_INNER", "bicgstab")
    if dtype_name == "float32":
        opts = SolveOptions(tol=1e-6, dtype=jnp.float32, precond_dtype=jnp.float32,
                            gmg=gmg_opts, inner_krylov=inner)
    elif dtype_name in ("mixed", "ir"):
        opts = SolveOptions(tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32,
                            gmg=gmg_opts, inner_krylov=inner)
    else:
        opts = SolveOptions(tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float64,
                            gmg=gmg_opts, inner_krylov=inner)

    solver = PoissonSolver(hierarchy, opts)
    # host-side setup cost (tables + GMG hierarchy), the section the
    # reference times as "Domain Initialization"+"GMG Setup"; the
    # reference's Schur *matrix formation* at 34M DOF was 40-361 s
    setup_s = time.time() - t_setup0
    f_np, exact = init_problem(hierarchy.finest, get_problem("trig", 2))
    f = jnp.asarray(f_np, dtype=opts.dtype)

    inner_tol = float(os.environ.get("PPS_BENCH_INNER_TOL", "1e-4"))

    def run_solve():
        if dtype_name == "ir":
            # mixed-precision iterative refinement: f32 Krylov + GMG inner
            # solves, f64 residual updates — reaches 1e-10 with nearly all
            # work in f32; the whole outer loop is one jitted while_loop.
            # sync=False keeps the iteration-count diagnostics on device:
            # a host scalar fetch is not part of the solve
            u, info = solver.solve_refined(
                f, tol=1e-10, inner_tol=inner_tol, sync=False)
            return u, {
                "outer": info["outer_iterations"],
                "inner": info["inner_iterations"],
            }

        res = solver.solve(f, max_iter=200)
        return res.x, {"outer": 1, "inner": res.iterations}

    # warm-up (compile)
    t0 = time.time()
    u, _ = run_solve()
    u.block_until_ready()
    compile_and_first = time.time() - t0

    # timed solves: best of N
    timed_reps = int(os.environ.get("PPS_BENCH_REPS", "3"))
    solve_s = float("inf")
    for _ in range(timed_reps):
        t0 = time.time()
        u, iters = run_solve()
        u.block_until_ready()
        solve_s = min(solve_s, time.time() - t0)
    iters = {k: int(v) for k, v in iters.items()}  # fetch after timing

    rep = solver.report(u, f, jnp.asarray(exact))
    res_x = u

    # composite-operator throughput (the BASELINE "stencil applications
    # nnz/s per chip" metric), timed in-graph (utils.profiling.time_op:
    # dynamic-trip fori_loop with a zero-trip calibration of the fixed
    # per-program cost).  Steady-state in-graph numbers are cache-
    # optimistic for loop-resident operands that fit the L2; the timing
    # mode is recorded alongside the numbers.
    from pressurepoissonsolver_tpu.utils.profiling import _device_bw, time_op

    bw = _device_bw()
    extras = {"apply_timing": "in_graph_steady_state"}
    # f64 composite apply (the IR outer-residual operator)
    apply64_s = time_op(solver.fine_level.apply, res_x, reps=200, in_graph=True)
    extras["apply_f64_ms"] = round(apply64_s * 1e3, 4)
    extras["apply_f64_roofline_pct"] = round(100 * (2 * dof * 8) / bw / apply64_s, 2)
    # f32 composite apply (the inner-Krylov operator, where the solve
    # time actually goes) — the headline nnz/s kernel number
    low = solver._fine_low
    if low is not None:
        res32 = res_x.astype(jnp.float32)
        apply32_s = time_op(low.apply, res32, reps=200, in_graph=True)
        extras["apply_f32_ms"] = round(apply32_s * 1e3, 4)
        extras["apply_f32_roofline_pct"] = round(
            100 * (2 * dof * 4) / bw / apply32_s, 2
        )
        nnz_per_s = 5 * dof / apply32_s
    else:
        nnz_per_s = 5 * dof / apply64_s

    # Schur-path complete solve (the reference's headline configuration):
    # GMG-Woodbury-preconditioned BiCGStab on the interface system + final
    # patch solves, f64 to 1e-10 (BASELINE: Schur+hypre 15-19 iterations,
    # 6.37 s at 2.13M DOF on 1 core)
    schur_extras = {}
    if os.environ.get("PPS_BENCH_SCHUR", "1") != "0":
        def run_schur():
            u_s, res_s = solver.solve_schur(
                f, tol=1e-10, max_iter=60, preconditioner="gmg"
            )
            u_s.block_until_ready()
            return u_s, res_s

        run_schur()  # compile
        schur_s = float("inf")
        for _ in range(max(timed_reps - 1, 1)):
            t0 = time.time()
            u_s, res_s = run_schur()
            schur_s = min(schur_s, time.time() - t0)
        rep_s = solver.report(u_s, f, jnp.asarray(exact))
        schur_extras = {
            "schur_complete_solve_s": round(schur_s, 4),
            "schur_dof_per_s": round(dof / schur_s, 1),
            "schur_iterations": int(res_s.iterations),
            "schur_residual": rep_s["residual"],
        }

    dof_per_s = dof / solve_s
    baseline_dof_per_s = 3.34e5  # reference 1-core Schur+hypre complete solve
    out = {
        "metric": "2d_adaptive_complete_solve_dof_per_s",
        "value": round(dof_per_s, 1),
        "unit": "DOF/s",
        "vs_baseline": round(dof_per_s / baseline_dof_per_s, 3),
        "dof": dof,
        "solve_s": round(solve_s, 4),
        "outer_iterations": iters["outer"],
        "inner_iterations": iters["inner"],
        "residual": rep["residual"],
        "error": rep["error"],
        "stencil_nnz_per_s": round(nnz_per_s, 1),
        **extras,
        **schur_extras,
        "setup_s": round(setup_s, 2),
        "compile_s": round(compile_and_first - solve_s, 2),
        "dtype": dtype_name,
        "device": device,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
