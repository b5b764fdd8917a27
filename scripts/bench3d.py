"""3D benchmark: time-to-1e-10 residual for the 3D FAC V-cycle solve
(the second BASELINE.json headline metric) on one GPU.

The mesh is built in code: ``refined_tree(3, 3, 2)`` (a 3D octree, uniform
to 3 levels with the origin corner refined twice more) refined
``PPS_BENCH3D_DIVIDE`` more times, cut into n^3 patches (default n=32:
78 patches, 2,555,904 DOF).  Refuses to run without a GPU; the output
names the device.

Run from the repo root:  PYTHONPATH=. python scripts/bench3d.py
"""

import json
import os
import time


def main():
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions
    from pressurepoissonsolver_tpu.utils.profiling import device_info

    device = device_info("gpu")
    n = int(os.environ.get("PPS_BENCH3D_N", "32"))
    divide = int(os.environ.get("PPS_BENCH3D_DIVIDE", "0"))
    tree = refined_tree(3, 3, 2)
    for _ in range(divide):
        tree.refine_leaves()
    h = DomainHierarchy(tree, n=n)
    dof = h.finest.num_cells
    mode = os.environ.get("PPS_BENCH3D_MODE", "ir")
    s = PoissonSolver(
        h, SolveOptions(tol=1e-10, precond_dtype=jnp.float32)
    )
    f, exact = init_problem(h.finest, get_problem("trig", 3))
    f = jnp.asarray(f)

    def run():
        if mode == "ir":
            # sync=False: a host scalar fetch is not part of the solve
            u, info = s.solve_refined(f, tol=1e-10, sync=False)
            return u, info["outer_iterations"], info["inner_iterations"]
        res = s.solve(f, max_iter=100)
        return res.x, 1, res.iterations

    u, _, _ = run()
    u.block_until_ready()
    reps = int(os.environ.get("PPS_BENCH3D_REPS", "2"))
    dt = float("inf")
    for _ in range(reps):
        t0 = time.time()
        u, outer, inner = run()
        u.block_until_ready()
        dt = min(dt, time.time() - t0)
    outer, inner = int(outer), int(inner)  # fetch after timing
    rep = s.report(u, f, jnp.asarray(exact))
    print(
        json.dumps(
            {
                "metric": "3d_adaptive_time_to_1e-10_s",
                "value": round(dt, 4),
                "unit": "s",
                "dof": dof,
                "dof_per_s": round(dof / dt, 1),
                "outer_iterations": outer,
                "inner_iterations": inner,
                "residual": rep["residual"],
                "error": rep["error"],
                "mode": mode,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
