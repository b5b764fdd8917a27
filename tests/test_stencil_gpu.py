"""The fused GPU stencil kernel (``ops/stencil_gpu.py``): the Pallas
interpreter on the CPU against the plain ``_star_stencil``, and its choice
inside ``Level``.  The compiled kernel runs only on a GPU (``gpu`` marker).

Tolerance: the kernel sums the same five terms as ``_star_stencil`` in
another order, so the two agree to a few f32 ulps of the largest term
(``|u| h^-2``); 1e-6 of ``max |ref|`` covers that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import refined_tree
from pressurepoissonsolver_tpu.ops import stencil_gpu
from pressurepoissonsolver_tpu.ops.level_ops import Level, _star_stencil

TOL = 1e-6


def _inputs(P, n, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    u = jnp.asarray(rng.standard_normal((P, n, n)), dtype)
    gf = jnp.asarray(rng.standard_normal((P, 4, n)), dtype)
    coef = jnp.asarray(rng.choice([-1.0, 0.0, 1.0], (P, 4)), dtype)
    h2 = jnp.asarray(rng.uniform(1.0, 64.0, (P, 2)), dtype)
    return u, gf, coef, h2


def _rel(a, b):
    return float(jnp.abs(a - b).max() / jnp.abs(b).max())


@pytest.mark.parametrize(
    "P,n,rows",
    [
        (4, 8, 8),  # one program per patch
        (5, 8, 2),  # several programs per patch; odd patch count
        (3, 16, 16),
        (6, 16, 1),  # one row per program: every row is a face row pair
        (7, 4, 4),
        (2, 8, 64),  # rows above n: clamped to whole patches
    ],
)
def test_kernel_matches_star_stencil(P, n, rows):
    u, gf, coef, h2 = _inputs(P, n)
    ref = _star_stencil(u, gf, coef, h2, 2, n)
    got = stencil_gpu.star_stencil_2d(u, gf, coef, h2, rows=rows, interpret=True)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert _rel(got, ref) <= TOL


def test_kernel_ghost_closures():
    """Zero interior field: only the ghost terms ``2 gf h^-2`` remain, on
    the boundary cells of their own side."""
    P, n = 2, 8
    _, gf, coef, h2 = _inputs(P, n, seed=1)
    u = jnp.zeros((P, n, n), jnp.float32)
    got = np.asarray(
        stencil_gpu.star_stencil_2d(u, gf, coef, h2, rows=4, interpret=True)
    )
    g, h = np.asarray(gf), np.asarray(h2)
    want = np.zeros((P, n, n), np.float32)
    want[:, :, 0] += 2 * g[:, 0] * h[:, :1]
    want[:, :, -1] += 2 * g[:, 1] * h[:, :1]
    want[:, 0, :] += 2 * g[:, 2] * h[:, 1:]
    want[:, -1, :] += 2 * g[:, 3] * h[:, 1:]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "D,n,dtype,ok",
    [
        (2, 64, jnp.float32, True),
        (2, 8, jnp.float32, True),
        (2, 64, jnp.float64, False),
        (2, 12, jnp.float32, False),
        (3, 16, jnp.float32, False),
    ],
)
def test_supported(D, n, dtype, ok):
    assert stencil_gpu.supported(D, n, dtype) is ok


def test_rows_must_divide_n():
    u, gf, coef, h2 = _inputs(2, 8)
    with pytest.raises(ValueError, match="power of two"):
        stencil_gpu.star_stencil_2d(u, gf, coef, h2, rows=3, interpret=True)


def test_level_apply_through_kernel_matches_xla():
    """``Level.apply`` with the kernel chosen (interpreted here) equals the
    XLA stencil path on an adaptive mesh, also through the FAC active-set
    residual apply."""
    h = DomainHierarchy(refined_tree(2, 3, 1), n=8)
    lvl = Level(h.finest, dtype=jnp.float32)
    assert lvl.fused_stencil is (jax.default_backend() == "gpu")
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal((lvl.P, 8, 8)), jnp.float32)
    from pressurepoissonsolver_tpu.ops.level_ops import ActiveSmoother

    active = np.zeros(lvl.P, bool)
    active[: lvl.P // 2] = True
    sub = ActiveSmoother(lvl, active, build_solver=False)
    u_act = jnp.where(jnp.asarray(active)[:, None, None], u, 0.0)
    lvl.fused_stencil = False
    ref, ref_sub = lvl.apply(u), sub.apply_scattered(u_act)
    lvl.fused_stencil = True
    got, got_sub = lvl.apply(u), sub.apply_scattered(u_act)
    assert _rel(got, ref) <= TOL
    assert _rel(got_sub, ref_sub) <= TOL


def test_mesh_turns_kernel_off():
    from pressurepoissonsolver_tpu.parallel.sharding import make_mesh

    h = DomainHierarchy(refined_tree(2, 2, 1), n=8, num_shards=2)
    lvl = Level(h.finest, dtype=jnp.float32)
    lvl.set_mesh(make_mesh(2))
    assert lvl.fused_stencil is False


@pytest.mark.gpu
def test_compiled_kernel_matches_star_stencil(gpu):
    """The kernel compiled for the GPU (not interpreted)."""
    u, gf, coef, h2 = _inputs(37, 64)
    ref = jax.jit(lambda *a: _star_stencil(*a, 2, 64))(u, gf, coef, h2)
    got = stencil_gpu.star_stencil_2d(u, gf, coef, h2, interpret=False)
    assert _rel(got, ref) <= TOL
