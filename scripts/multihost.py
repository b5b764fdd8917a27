"""Multi-process validation on the CPU: 2 real processes x 4 virtual CPU
devices each.  This is a CPU-only check of the multi-process path; it
measures nothing and does not run on a GPU.

The reference's identity is ``mpirun -np N steady`` (MPI ranks exchanging
interface data, ``apps/3d/steady.cpp:76``); the equivalent here is N JAX
processes in one ``jax.distributed`` job, each owning a slice of the
device mesh, with the halo exchange riding XLA's cross-process collectives
(gloo on the CPU).  This script validates that story end to end:

* parent mode (no args): runs the single-process reference solve, then
  spawns 2 coordinated worker processes, compares, and prints the report.
* worker mode (``--process-id i``): joins the 2-process gloo job, runs the
  public ``PoissonSolver`` sharded solve (both comm engines) on the same
  problem, and process 0 writes the gathered solution.

Run:  JAX_PLATFORMS=cpu python scripts/multihost.py
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NDEV_PER_PROC = 4
NPROC = 2
PORT = 12377


def build_problem():
    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import refined_tree
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem

    tree = refined_tree(2, 4, 2)
    h = DomainHierarchy(tree, n=8, num_shards=NDEV_PER_PROC * NPROC)
    f, exact = init_problem(h.finest, get_problem("trig", 2))
    return h, f, exact


def worker(process_id: int, outdir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=NPROC,
        process_id=process_id,
    )
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec

    from pressurepoissonsolver_tpu.parallel.sharding import make_mesh
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    assert jax.process_count() == NPROC, jax.process_count()
    ndev = jax.device_count()
    assert ndev == NDEV_PER_PROC * NPROC, ndev
    mesh = make_mesh(ndev)
    h, f_np, _ = build_problem()
    sh = NamedSharding(mesh, PartitionSpec("p"))
    f = jax.make_array_from_callback(f_np.shape, sh, lambda idx: f_np[idx])

    out = {}
    for comm in ("pjit", "halo"):
        solver = PoissonSolver(
            h, SolveOptions(tol=1e-11, comm=comm), mesh=mesh
        )
        res = solver.solve(f)
        u = multihost_utils.process_allgather(res.x, tiled=True)
        out[comm] = {
            "iterations": int(res.iterations),
            "residual": float(res.residual_norm / res.r0_norm),
        }
        if process_id == 0:
            np.save(os.path.join(outdir, f"u_{comm}.npy"), np.asarray(u))
    if process_id == 0:
        with open(os.path.join(outdir, "worker.json"), "w") as fh:
            json.dump(out, fh)


def parent() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    h, f_np, _ = build_problem()
    ref = PoissonSolver(h, SolveOptions(tol=1e-11))
    u_ref = np.asarray(ref.solve(jnp.asarray(f_np)).x)

    outdir = tempfile.mkdtemp(prefix="pps_multihost_")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={NDEV_PER_PROC}"
    ).strip()
    env["PPS_NO_COMPILE_CACHE"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--process-id", str(i), "--outdir", outdir],
            env=env, cwd=REPO,
        )
        for i in range(NPROC)
    ]
    rc = [p.wait(timeout=900) for p in procs]
    if any(rc):
        print(f"worker exit codes: {rc}", file=sys.stderr)
        return 1

    with open(os.path.join(outdir, "worker.json")) as fh:
        winfo = json.load(fh)
    report = {
        "processes": NPROC,
        "devices_per_process": NDEV_PER_PROC,
        "dof": int(np.prod(f_np.shape)),
        "backend": "cpu (gloo cross-process collectives)",
    }
    ok = True
    for comm in ("pjit", "halo"):
        u = np.load(os.path.join(outdir, f"u_{comm}.npy"))
        err = float(np.abs(u - u_ref).max())
        match = err < 1e-9
        ok = ok and match
        report[comm] = {**winfo[comm], "max_abs_diff_vs_1proc": err,
                        "match": match}
    report["ok"] = ok
    print(json.dumps(report, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--outdir", type=str, default=None)
    a = ap.parse_args()
    if a.process_id is None:
        sys.exit(parent())
    worker(a.process_id, a.outdir)
