"""Scaling harness: stencil throughput and solve scaling over device counts
(BASELINE.md: nnz/s at 1 chip / 1 host / N hosts).

Runs the PUBLIC sharded API (``DomainHierarchy(num_shards=...)`` +
``PoissonSolver(..., mesh=...)``) for both communication schedules
(``pjit`` and the cut-face ``halo`` engine) and prints one JSON line per
configuration.

On CPU (JAX_PLATFORMS=cpu + xla_force_host_platform_device_count) this
validates the sharded execution path over N *virtual* devices sharing one
host's cores — useful for correctness and comm-schedule comparison, NOT a
hardware scaling claim.  On the GPUs of one host the same code runs its
exchanges as NCCL collectives over NVLink.  The mesh is the in-repo
``refined_tree(2, 5, 2)`` refined ``--divide`` times.
"""

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1])
    ap.add_argument("--divide", type=int, default=1)
    ap.add_argument("-n", type=int, default=16)
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--comm", type=str, nargs="+", default=["pjit", "halo"])
    ap.add_argument("--solve", action="store_true",
                    help="also time a complete solve to 1e-8")
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling: DOF grows with the device count "
                    "(each 4x device step adds one uniform refinement, so "
                    "DOF/device is constant); reports weak efficiency vs "
                    "the first configuration and per-device comm rows")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.parallel.sharding import make_mesh
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64
    tree = refined_tree(2, 5, 2)
    for _ in range(args.divide):
        tree.refine_leaves()

    # weak mode: devices must step by powers of 4 from the first entry
    # (each step = one uniform refinement = 4x DOF, keeping DOF/device
    # constant — the reference protocol: 2.1M DOF on 1 core -> 136M on 64,
    # misc/results/..._Weak_Scaling.ipynb cells 3/7)
    weak_trees = {}
    if args.weak:
        t = tree
        weak_trees[args.devices[0]] = t
        for ndev in args.devices[1:]:
            ratio = ndev // args.devices[0]
            extra = 0
            while 4 ** extra < ratio:
                extra += 1
            if 4 ** extra != ratio:
                raise SystemExit(
                    f"--weak needs device ratios that are powers of 4 "
                    f"(got {ndev}/{args.devices[0]})"
                )
            import copy

            t2 = copy.deepcopy(tree)
            for _ in range(extra):
                t2.refine_leaves()
            weak_trees[ndev] = t2
    base_time = {}

    for ndev in args.devices:
        for comm in (args.comm if ndev > 1 else ["pjit"]):
            mesh = make_mesh(ndev) if ndev > 1 else None
            use_tree = weak_trees[ndev] if args.weak else tree
            h = DomainHierarchy(use_tree, n=args.n, num_shards=ndev)
            opts = SolveOptions(
                dtype=dtype, precond_dtype=dtype, comm=comm, tol=1e-8
            )
            solver = PoissonSolver(h, opts, mesh=mesh)
            dof = h.finest.real_patches * h.finest.cells_per_patch
            nnz = (2 * h.finest.D + 1) * dof
            rng = np.random.default_rng(0)
            u = solver._device_put(
                jnp.asarray(
                    rng.standard_normal(
                        (h.finest.num_patches,) + h.finest.ns_shape
                    ),
                    dtype=dtype,
                )
            )
            A = solver._op.apply

            inner = 50

            @jax.jit
            def loop(v):
                def body(i, x):
                    return A(x) * jnp.asarray(1e-3, dtype)

                return jax.lax.fori_loop(0, inner, body, v)

            loop(u).block_until_ready()
            t0 = time.time()
            reps = 5
            for _ in range(reps):
                out = loop(u)
            out.block_until_ready()
            t = (time.time() - t0) / reps / inner

            rec = {
                "devices": ndev,
                "comm": comm if ndev > 1 else "single",
                "dof": dof,
                "dof_per_device": dof // ndev,
                "apply_ms": round(t * 1e3, 4),
                "nnz_per_s": round(nnz / t, 1),
                "dtype": args.dtype,
                "platform": jax.devices()[0].platform,
            }
            if comm == "halo" and ndev > 1:
                rec["cut_face_rows"] = solver._op.comm_rows
                rec["cut_face_rows_per_device"] = round(
                    solver._op.comm_rows / ndev, 1
                )
            if args.weak:
                rec["mode"] = "weak"
                # weak efficiency: constant work per device => the ideal
                # apply time is flat; efficiency = t(first) / t(this)
                if "apply" not in base_time:
                    base_time["apply"] = t
                rec["weak_efficiency_apply"] = round(
                    base_time["apply"] / t, 4
                )
            if args.solve:
                f_np, _ = init_problem(h.finest, get_problem("trig", 2))
                f = jnp.asarray(f_np, dtype=dtype)
                res = solver.solve(f, tol=1e-6)
                res.x.block_until_ready()
                t0 = time.time()
                res = solver.solve(f, tol=1e-6)
                res.x.block_until_ready()
                rec["solve_s"] = round(time.time() - t0, 4)
                rec["iterations"] = int(res.iterations)
                if args.weak:
                    if "solve" not in base_time:
                        base_time["solve"] = rec["solve_s"]
                    rec["weak_efficiency_solve"] = round(
                        base_time["solve"] / rec["solve_s"], 4
                    )
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
