"""``chip_smoke.py``'s phases at tiny meshes on the CPU, against the same
plain references the GPU run uses; its device check; the device peak
table; the compile-cache location."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pressurepoissonsolver_tpu import compile_cache_dir
from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import refined_tree
from pressurepoissonsolver_tpu.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small2d(cs):
    """A tiny 2D adaptive mesh, its problem, and the IR phase's output."""
    h = DomainHierarchy(refined_tree(2, 3, 1), n=8)
    f, exact = cs._problem(h, 2)
    rec, solver, u = cs.phase_solve2d_ir(h, f, exact)
    return h, f, exact, rec, solver, u


def test_device_check_raises_without_gpu(cs):
    with pytest.raises(RuntimeError, match="gpu"):
        cs.phase_device()
    with pytest.raises(RuntimeError, match="gpu"):
        profiling.device_info("gpu")


def test_device_phase_on_cpu(cs):
    rec = cs.phase_device("cpu")
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices())
    assert rec["nvidia_smi"] is None
    assert isinstance(rec["native_tablegen"], bool)


def test_device_peaks_table():
    h100 = profiling.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["cache_bytes"] == 50e6
    assert profiling.device_peaks("cpu")["hbm_bytes_per_s"] > 0
    assert profiling.device_peaks() == profiling.device_peaks("cpu")


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", ""])
def test_device_peaks_unknown_device_raises(kind):
    with pytest.raises(ValueError, match="no peak figures"):
        profiling.device_peaks(kind)


def test_compile_cache_honours_env():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/cache", "PPS_NO_COMPILE_CACHE": "1"}
    assert compile_cache_dir(env) == "/some/cache"


def test_compile_cache_default_inside_checkout():
    d = compile_cache_dir({})
    assert d == os.path.join(ROOT, ".jax_cache")
    assert compile_cache_dir({}) == d  # a fixed path, not a fresh name
    assert compile_cache_dir({"PPS_NO_COMPILE_CACHE": "1"}) is None


def test_phase_reference_small(cs):
    recs = cs.phase_reference_small(
        ((2, refined_tree(2, 2, 1), 8), (3, refined_tree(3, 2, 1), 4))
    )
    assert [r["phase"] for r in recs] == ["reference_small_2d", "reference_small_3d"]
    for r in recs:
        assert r["vs_spsolve_rel_maxdiff"] <= cs.REF_SMALL_TOL
        assert r["cond1_estimate"] > 1.0


def test_phase_solve2d_ir(small2d, cs):
    h, f, exact, rec, _, u = small2d
    assert rec["dof"] == h.finest.num_cells and u.shape == f.shape
    assert rec["host_residual"] <= cs.HOST_RESIDUAL_TOL
    assert rec["outer_iterations"] >= 1


def test_phase_solve2d_f64(small2d, cs):
    h, f, exact, _, _, u = small2d
    rec = cs.phase_solve2d_f64(h, f, exact, u)
    assert rec["vs_ir_rel_maxdiff"] <= cs.AGREE_TOL


def test_phase_schur2d(small2d, cs):
    h, f, exact, _, solver, u = small2d
    rec = cs.phase_schur2d(solver, f, exact, u)
    assert rec["vs_composite_rel_maxdiff"] <= cs.AGREE_TOL


def test_phase_solve3d_ir(cs):
    rec = cs.phase_solve3d_ir(refined_tree(3, 2, 1), 4)
    assert rec["residual"] <= cs.TOL and rec["patches"] == 15


def test_phase_cli(cs, tmp_path):
    rec = cs.phase_cli(refined_tree(2, 3, 1), 8, workdir=str(tmp_path))
    assert rec["residual"] < cs.TOL


def test_phase_stencil(cs):
    rec = cs.phase_stencil(refined_tree(2, 3, 1), 8, inner=2, reps=1)
    assert rec["field_bytes"] == rec["dof"] * 4
    assert rec["xla_roofline_share"] > 0 and rec["kernel_roofline_share"] > 0
    assert rec["copy_roofline_share"] > 0
    assert rec["kernel_vs_xla_rel_maxdiff"] <= cs.STENCIL_TOL


def test_phase_multi_on_virtual_devices(cs):
    """The --multi path on 4 of the 8 virtual CPU devices the tests use."""
    rec = cs.phase_multi(refined_tree(2, 3, 1), 8, ndev=4)
    assert rec["devices"] == 4
    assert rec["vs_one_card_rel_maxdiff"] <= cs.MULTI_TOL


def test_time_chain_counts_calls(cs):
    calls = []

    def fn(v):
        calls.append(1)  # traced once per chained call
        return v + 1.0

    t = cs.time_chain(fn, jnp.zeros((4,), jnp.float32), inner=3, reps=1)
    assert t > 0 and len(calls) == 3
