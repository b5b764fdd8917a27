"""CLI app / writer / timer / config tests."""

import json
import os

import numpy as np
import pytest

from pressurepoissonsolver_tpu.cli import main
from pressurepoissonsolver_tpu.geometry import refined_tree, uniform_tree
from pressurepoissonsolver_tpu.utils.timer import Timer


def test_steady2d_cli(tmp_path):
    out_json = str(tmp_path / "out.json")
    rc = main(
        2,
        [
            "--uniform", "2", "-n", "8", "-t", "1e-11",
            "--out-json", out_json,
            "--out-claw", str(tmp_path / "claw"),
            "--out-vtk", str(tmp_path / "vtk"),
            "--output-config", str(tmp_path / "cfg.ini"),
        ],
    )
    assert rc == 0
    rep = json.load(open(out_json))
    assert rep["residual"] < 1e-10
    assert rep["error"] < 0.05
    assert os.path.exists(tmp_path / "claw" / "fort.q0000")
    assert os.path.exists(str(tmp_path / "vtk") + ".vtm")
    assert os.path.exists(tmp_path / "vtk" / "patch000000.vti")
    # config round trip: reading the written config reproduces the solve
    rc = main(2, ["--config", str(tmp_path / "cfg.ini"), "--out-json", out_json])
    assert rc == 0
    rep2 = json.load(open(out_json))
    assert rep2["iterations"] == rep["iterations"]


def test_steady2d_schur_cli(tmp_path):
    out_json = str(tmp_path / "out.json")
    rc = main(2, ["--uniform", "2", "-n", "8", "--schur", "-t", "1e-12",
                  "--out-json", out_json])
    assert rc == 0
    rep = json.load(open(out_json))
    assert rep["residual"] < 1e-9


def test_steady3d_cli(tmp_path):
    out_json = str(tmp_path / "out.json")
    mesh = str(tmp_path / "2uni.bin")
    uniform_tree(3, 2).to_file(mesh)
    rc = main(3, ["--mesh", mesh, "-n", "8",
                  "-t", "1e-11", "--out-json", out_json])
    assert rc == 0
    rep = json.load(open(out_json))
    assert rep["residual"] < 1e-10


def test_timer_report():
    t = Timer()
    with t.section("A"):
        pass
    with t.section("B"):
        pass
    with t.section("B"):
        pass
    rep = t.report()
    assert "A" in rep and "B (2 repeats)" in rep
    assert t["A"] >= 0


def test_residual_history():
    import jax.numpy as jnp
    from pressurepoissonsolver_tpu.domain import DomainHierarchy
    from pressurepoissonsolver_tpu.geometry import uniform_tree
    from pressurepoissonsolver_tpu.krylov import residual_history
    from pressurepoissonsolver_tpu.ops.level_ops import Level
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem

    t = uniform_tree(2, 3)
    h = DomainHierarchy(t, n=4)
    lvl = Level(h.finest)
    f, _ = init_problem(h.finest, get_problem("trig", 2))
    res, hist = residual_history(lvl.apply, jnp.asarray(f), tol=1e-10, max_iter=100)
    hist = np.asarray(hist)
    assert hist[0] > 0
    assert float(res.residual_norm / res.r0_norm) < 1e-10
    # residual history is meaningful: strictly decreasing overall
    assert hist[int(res.iterations)] / hist[0] < 1e-10


def test_cli_monitor_prints_history(tmp_path, capsys):
    rc = main(2, ["--uniform", "2", "-n", "8", "-t", "1e-10",
                  "--monitor", "--max_iterations", "40"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "rel residual" in l]
    assert len(lines) >= 2
    assert "1.000000e+00" in lines[0]
    assert float(lines[-1].split()[-1]) < 1e-10


def test_cli_schur_gmg_prec(tmp_path):
    out_json = str(tmp_path / "out.json")
    rc = main(2, ["--uniform", "3", "-n", "8", "--schur", "--prec", "GMG",
                  "-t", "1e-10", "--out-json", out_json])
    assert rc == 0
    rep = json.load(open(out_json))
    assert rep["residual"] < 1e-9
    assert rep["iterations"] <= 12


def test_cli_neumann_sides(tmp_path):
    out_json = str(tmp_path / "out.json")
    rc = main(2, ["--uniform", "3", "-n", "8", "-t", "1e-10",
                  "--neumann-sides", "x_lo,y_hi", "--out-json", out_json])
    assert rc == 0
    rep = json.load(open(out_json))
    assert rep["residual"] < 1e-9
    assert rep["error"] < 3e-2


def test_out_matrix_rhs(tmp_path):
    import scipy.sparse as sp

    mpath = str(tmp_path / "A.npz")
    rpath = str(tmp_path / "rhs.npy")
    rc = main(2, ["--uniform", "2", "-n", "4", "-t", "1e-10",
                  "--out-matrix", mpath, "--out-rhs", rpath])
    assert rc == 0
    A = sp.load_npz(mpath)
    rhs = np.load(rpath)
    assert A.shape[0] == rhs.size


def test_cli_sharded_halo(tmp_path, capsys):
    """--shards 8 --comm halo end-to-end through the CLI."""
    from pressurepoissonsolver_tpu import cli

    out = tmp_path / "m.json"
    rc = cli.main(
        2,
        [
            "--uniform", "3", "-n", "8", "-t", "1e-10",
            "--shards", "8", "--comm", "halo",
            "--out-json", str(out),
        ],
    )
    assert rc == 0
    import json

    rep = json.loads(out.read_text())
    assert rep["residual"] < 1e-9


def test_cli_ir_solver(tmp_path):
    """--solver ir reports outer/inner iterations and converges."""
    from pressurepoissonsolver_tpu import cli

    out = tmp_path / "m.json"
    rc = cli.main(
        2,
        ["--uniform", "3", "-n", "8", "--solver", "ir", "-t", "1e-10",
         "--out-json", str(out)],
    )
    assert rc == 0
    import json

    rep = json.loads(out.read_text())
    assert rep["residual"] < 1e-9
    assert rep["outer_iterations"] >= 1
    assert rep["inner_iterations"] >= 1


def test_cli_crs_matches_wrap(tmp_path):
    """--matrix-type crs solves to the same solution as matrix-free."""
    import json

    from pressurepoissonsolver_tpu import cli

    outs = []
    for mt in ("wrap", "crs"):
        out = tmp_path / f"{mt}.json"
        cli.main(
            2,
            ["--uniform", "2", "-n", "8", "-t", "1e-11",
             "--matrix-type", mt, "--out-json", str(out)],
        )
        outs.append(json.loads(out.read_text()))
    assert abs(outs[0]["error"] - outs[1]["error"]) < 1e-9


def test_cli_gmg_and_ir_knobs(tmp_path):
    """Round-3 CLI parity: fac-smoothing/coarse-direct/inner-tol knobs and
    --out-gamma (reference exposes all cycle knobs via CLI11+ini;
    apps/3d/steady.cpp:570-574 saves gamma)."""
    out_json = str(tmp_path / "out.json")
    gamma_path = str(tmp_path / "gamma.npy")
    mesh = str(tmp_path / "2d2ref.bin")
    refined_tree(2, 2, 1).to_file(mesh)
    rc = main(
        2,
        [
            "--mesh", mesh,
            "-n", "8", "--solver", "ir", "-t", "1e-10",
            "--inner-tol", "1e-4",
            "--gmg-fac-smoothing", "active", "--gmg-fac-ring", "1",
            "--gmg-pre-sweeps", "2", "--gmg-coarse-direct-dof", "2048",
            "--out-json", out_json,
        ],
    )
    assert rc == 0
    rep = json.load(open(out_json))
    assert rep["residual"] < 1e-10
    assert rep["outer_iterations"] >= 1 and rep["inner_iterations"] >= 1

    rc = main(2, ["--uniform", "2", "-n", "8", "--schur", "-t", "1e-12",
                  "--out-gamma", gamma_path, "--out-json", out_json])
    assert rc == 0
    g = np.load(gamma_path)
    assert g.ndim == 2 and g.shape[1] == 8 and np.isfinite(g).all()
    assert np.abs(g).max() > 0


def test_cli_rejects_bad_combos():
    """Unsupported option combinations error out up front, as in the
    reference (apps/3d/steady.cpp:389-392)."""
    import pytest as _pytest

    for argv in (
        ["--uniform", "2", "-n", "8", "--matrix-type", "crs", "--solver", "ir"],
        ["--uniform", "2", "-n", "8", "--matrix-type", "crs", "--schur",
         "--shards", "2"],
        ["--uniform", "2", "-n", "8", "--matrix-type", "crs", "--monitor"],
        ["--uniform", "2", "-n", "8", "--prec", "cheb"],
    ):
        with _pytest.raises(SystemExit):
            main(2, argv)


def test_cli_monitor_cg_gmres_ir(tmp_path, capsys):
    """--monitor now covers cg/gmres (per-iteration) and ir (per outer
    round)."""
    for solver in ("cg", "gmres"):
        rc = main(2, ["--uniform", "2", "-n", "8", "-t", "1e-10",
                      "--solver", solver, "--monitor",
                      "--max_iterations", "60"])
        assert rc == 0
        lines = [l for l in capsys.readouterr().out.splitlines()
                 if "rel residual" in l]
        assert len(lines) >= 2, solver
        assert float(lines[-1].split()[-1]) < 1e-9, solver

    rc = main(2, ["--uniform", "2", "-n", "8", "-t", "1e-10",
                  "--solver", "ir", "--monitor"])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "outer" in l and "rel residual" in l]
    assert len(lines) >= 2
    assert float(lines[-1].split()[-1]) < 1e-10
