"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pressurepoissonsolver_tpu.domain import DomainHierarchy
from pressurepoissonsolver_tpu.geometry import refined_tree, uniform_tree
from pressurepoissonsolver_tpu.ops.level_ops import Level
from pressurepoissonsolver_tpu.parallel.sharding import (
    make_mesh,
    pad_level,
    patch_sharding,
    shard_patch_array,
)


def test_eight_virtual_devices():
    assert len(jax.devices()) >= 8


def test_pad_level_noop_ops():
    """Dummy patches stay identically zero under apply/smooth."""
    t = uniform_tree(2, 3)
    h = DomainHierarchy(t, n=4)
    pl = pad_level(h.finest, 7)  # 16 -> 21
    assert pl.num_patches == 21
    lvl = Level(pl)
    rng = np.random.default_rng(0)
    u = np.zeros((21, 4, 4))
    u[:16] = rng.standard_normal((16, 4, 4))
    au = np.asarray(lvl.apply(jnp.asarray(u)))
    assert np.abs(au[16:]).max() == 0.0
    # real patches unaffected by padding
    lvl0 = Level(h.finest)
    au0 = np.asarray(lvl0.apply(jnp.asarray(u[:16])))
    np.testing.assert_allclose(au[:16], au0, rtol=1e-12)


def test_sharded_apply_matches_single_device():
    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=4)
    pl = pad_level(h.finest, ndev)
    lvl = Level(pl)
    rng = np.random.default_rng(1)
    u_np = rng.standard_normal((pl.num_patches, 4, 4))

    ref = np.asarray(lvl.apply(jnp.asarray(u_np)))

    u = shard_patch_array(jnp.asarray(u_np), mesh)
    sh = patch_sharding(mesh)
    f = jax.jit(
        lambda x: jax.lax.with_sharding_constraint(lvl.apply(x), sh)
    )
    out = f(u)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)
    assert out.sharding.is_equivalent_to(sh, out.ndim)


def test_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_entry_compiles():
    import sys

    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()
    assert out.shape == args[0].shape


def test_halo_apply_matches_global():
    """Explicit shard_map halo-exchange apply == global apply, 8 devices."""
    from pressurepoissonsolver_tpu.parallel.halo import HaloApply

    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=8)
    pl = pad_level(h.finest, ndev)
    lvl = Level(pl)
    rng = np.random.default_rng(5)
    u_np = rng.standard_normal((pl.num_patches, 8, 8))
    ref = np.asarray(lvl.apply(jnp.asarray(u_np)))
    ha = HaloApply(lvl, mesh)
    u = shard_patch_array(jnp.asarray(u_np), mesh)
    out = jax.jit(ha)(u)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)
    assert out.sharding.is_equivalent_to(patch_sharding(mesh), out.ndim)


def _id_align(sharded_pl, plain_pl):
    """Map sharded (Morton-ordered, padded) patch slots to plain slots."""
    nr = sharded_pl.real_patches
    return np.searchsorted(plain_pl.ids, sharded_pl.ids[:nr]), nr


def test_public_sharded_solver_matches_single_device():
    """The production PoissonSolver in mesh mode == single-device solve."""
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)

    h1 = DomainHierarchy(t, n=8)
    s1 = PoissonSolver(h1, SolveOptions(tol=1e-11))
    f1, _ = init_problem(h1.finest, get_problem("trig", 2))
    r1 = s1.solve(jnp.asarray(f1))

    h8 = DomainHierarchy(t, n=8, num_shards=ndev)
    assert h8.finest.num_patches % ndev == 0
    s8 = PoissonSolver(h8, SolveOptions(tol=1e-11), mesh=mesh)
    f8, _ = init_problem(h8.finest, get_problem("trig", 2))
    r8 = s8.solve(jnp.asarray(f8))

    assert len(r8.x.sharding.device_set) == ndev
    pos, nr = _id_align(h8.finest, h1.finest)
    np.testing.assert_allclose(
        np.asarray(r8.x)[:nr], np.asarray(r1.x)[pos], atol=1e-9
    )
    # dummy patches stayed zero
    assert np.abs(np.asarray(r8.x)[nr:]).max() == 0.0


def test_public_sharded_mixed_bc_matches_single_device():
    """Per-side Neumann walls through the halo engine: the multi-group
    spectral path (REDFT11/RODFT11 per-axis kinds) must match the
    single-device solve."""
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)
    sides = ["x_lo", "y_hi"]

    h1 = DomainHierarchy(t, n=8, neumann=sides)
    s1 = PoissonSolver(h1, SolveOptions(tol=1e-11))
    f1, _ = init_problem(h1.finest, get_problem("trig", 2))
    r1 = s1.solve(jnp.asarray(f1))

    h8 = DomainHierarchy(t, n=8, neumann=sides, num_shards=ndev)
    s8 = PoissonSolver(h8, SolveOptions(tol=1e-11), mesh=mesh)
    f8, _ = init_problem(h8.finest, get_problem("trig", 2))
    r8 = s8.solve(jnp.asarray(f8))

    assert float(r8.residual_norm / r8.r0_norm) < 1e-10
    pos, nr = _id_align(h8.finest, h1.finest)
    np.testing.assert_allclose(
        np.asarray(r8.x)[:nr], np.asarray(r1.x)[pos], atol=1e-9
    )


def test_public_sharded_solve_refined():
    """Mixed-precision IR through the public API on the 8-device mesh."""
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)
    h8 = DomainHierarchy(t, n=8, num_shards=ndev)
    s8 = PoissonSolver(
        h8,
        SolveOptions(tol=1e-10, dtype=jnp.float64, precond_dtype=jnp.float32),
        mesh=mesh,
    )
    f8, exact = init_problem(h8.finest, get_problem("trig", 2))
    u, info = s8.solve_refined(jnp.asarray(f8), tol=1e-10)
    assert info["residual"] <= 1e-10
    assert info["inner_iterations"] > 0
    rep = s8.report(u, jnp.asarray(f8), jnp.asarray(exact))
    assert rep["residual"] <= 1e-9


def test_morton_partition_cuts_fewer_faces():
    """The wired-in Morton partition induces no more cut faces than the
    raw id-order block partition (the Zoltan objective, SURVEY §2.2)."""
    from pressurepoissonsolver_tpu.parallel.partition import (
        block_partition,
        cut_faces,
        morton_order,
        reorder_level,
    )

    t = refined_tree(2, 4, 2)
    h = DomainHierarchy(t, n=4)
    pl = h.finest
    ndev = 8
    shard_raw = block_partition(pl.num_patches, ndev)
    raw_cuts = cut_faces(pl, shard_raw)
    plm = reorder_level(pl, morton_order(pl))
    morton_cuts = cut_faces(plm, block_partition(plm.num_patches, ndev))
    assert morton_cuts <= raw_cuts


def test_halo_apply_3d():
    from pressurepoissonsolver_tpu.parallel.halo import HaloApply

    ndev = 4
    mesh = make_mesh(ndev)
    t = refined_tree(3, 2, 1)
    h = DomainHierarchy(t, n=4)
    pl = pad_level(h.finest, ndev)
    lvl = Level(pl)
    rng = np.random.default_rng(6)
    u_np = rng.standard_normal((pl.num_patches, 4, 4, 4))
    ref = np.asarray(lvl.apply(jnp.asarray(u_np)))
    ha = HaloApply(lvl, mesh)
    u = shard_patch_array(jnp.asarray(u_np), mesh)
    out = jax.jit(ha)(u)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-12, atol=1e-12)


def _sharded_setup(D=2, n=8, ndev=8, neumann=False, seed=11):
    from pressurepoissonsolver_tpu.ops.level_ops import Level as L

    mesh = make_mesh(ndev)
    t = refined_tree(D, 3 if D == 2 else 2, 1)
    h = DomainHierarchy(t, n=n, neumann=neumann, num_shards=ndev)
    lvl = L(h.finest)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((lvl.P,) + h.finest.ns_shape)
    return mesh, h, lvl, u


def test_sharded_level_smooth_matches():
    from pressurepoissonsolver_tpu.parallel.halo import ShardedLevel

    mesh, h, lvl, u = _sharded_setup()
    f = np.random.default_rng(1).standard_normal(u.shape)
    sl = ShardedLevel(lvl, mesh)
    ref = np.asarray(lvl.smooth(jnp.asarray(f), jnp.asarray(u)))
    out = np.asarray(sl.smooth(jnp.asarray(f), jnp.asarray(u)))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    ref0 = np.asarray(lvl.smooth_zero(jnp.asarray(f)))
    out0 = np.asarray(sl.smooth_zero(jnp.asarray(f)))
    np.testing.assert_allclose(out0, ref0, rtol=1e-12, atol=1e-12)


def test_sharded_level_smooth_neumann_multigroup():
    """Neumann mesh: multiple BC groups -> gathered per-patch transforms."""
    from pressurepoissonsolver_tpu.parallel.halo import ShardedLevel

    mesh, h, lvl, u = _sharded_setup(neumann=True)
    assert len(lvl._solve_groups) > 1
    f = np.random.default_rng(2).standard_normal(u.shape)
    sl = ShardedLevel(lvl, mesh)
    assert not sl._single_group
    ref = np.asarray(lvl.smooth(jnp.asarray(f), jnp.asarray(u)))
    out = np.asarray(sl.smooth(jnp.asarray(f), jnp.asarray(u)))
    np.testing.assert_allclose(out, ref, rtol=1e-11, atol=1e-11)


def test_sharded_level_apply_3d_matches():
    from pressurepoissonsolver_tpu.parallel.halo import ShardedLevel

    mesh, h, lvl, u = _sharded_setup(D=3, n=4, ndev=4)
    sl = ShardedLevel(lvl, mesh)
    ref = np.asarray(lvl.apply(jnp.asarray(u)))
    out = np.asarray(sl.apply(jnp.asarray(u)))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_sharded_transfers_match():
    from pressurepoissonsolver_tpu.gmg import Transfer
    from pressurepoissonsolver_tpu.ops.level_ops import Level as L
    from pressurepoissonsolver_tpu.parallel.halo import (
        ShardedLevel,
        ShardedTransfer,
    )

    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)
    h = DomainHierarchy(t, n=8, num_shards=ndev)
    rng = np.random.default_rng(3)
    for mode in ("constant", "linear"):
        fine, coarse = L(h[0]), L(h[1])
        tr = Transfer(fine, coarse, prolong_mode=mode)
        st = ShardedTransfer(
            tr, ShardedLevel(fine, mesh), ShardedLevel(coarse, mesh)
        )
        uf = rng.standard_normal((fine.P,) + h[0].ns_shape)
        uc = rng.standard_normal((coarse.P,) + h[1].ns_shape)
        ref_r = np.asarray(tr.restrict(jnp.asarray(uf)))
        out_r = np.asarray(st.restrict(jnp.asarray(uf)))
        np.testing.assert_allclose(out_r, ref_r, rtol=1e-12, atol=1e-12)
        ref_p = np.asarray(tr.prolong_add(jnp.asarray(uc), jnp.asarray(uf)))
        out_p = np.asarray(st.prolong_add(jnp.asarray(uc), jnp.asarray(uf)))
        np.testing.assert_allclose(out_p, ref_p, rtol=1e-12, atol=1e-12)


def test_halo_comm_volume_bounded_by_cut_faces():
    """The exchange moves at most one face row per directed cut face."""
    from pressurepoissonsolver_tpu.parallel.halo import ShardedLevel
    from pressurepoissonsolver_tpu.parallel.partition import (
        block_partition,
        cut_faces,
    )

    for neumann in (False, True):
        mesh, h, lvl, _ = _sharded_setup(neumann=neumann)
        sl = ShardedLevel(lvl, mesh)
        shard_of = block_partition(h.finest.num_patches, 8)
        cuts = cut_faces(h.finest, shard_of)
        assert 0 < sl.comm_rows <= cuts


def test_sharded_schur_ops_match_single_device():
    """Halo-engine Schur entry points (interpolate / patch_solve / S) ==
    single-device Level, 8 devices (SchurHelper.h:281-331 distributed)."""
    from pressurepoissonsolver_tpu.parallel.halo import ShardedLevel

    mesh, h, lvl, u = _sharded_setup()
    sl = ShardedLevel(lvl, mesh)
    rng = np.random.default_rng(7)
    gamma_ref = rng.standard_normal((lvl.num_ifaces, lvl.m))
    NOg = max(sl.NOg, 1)
    g_sh = np.zeros((sl.ndev * NOg, lvl.m))
    for r, ids in enumerate(sl._owned_ids):
        for k, i in enumerate(ids):
            g_sh[r * NOg + k] = gamma_ref[i]

    gi_ref = np.asarray(lvl.interpolate(jnp.asarray(u)))
    gi_sh = sl.gamma_global(sl.interpolate(jnp.asarray(u)))
    np.testing.assert_allclose(gi_sh, gi_ref, rtol=1e-12, atol=1e-12)

    f = rng.standard_normal(u.shape)
    ps_ref = np.asarray(lvl.patch_solve(jnp.asarray(f), jnp.asarray(gamma_ref)))
    ps_sh = np.asarray(sl.patch_solve(jnp.asarray(f), jnp.asarray(g_sh)))
    np.testing.assert_allclose(ps_sh, ps_ref, rtol=1e-11, atol=1e-11)

    S_ref = np.asarray(lvl.schur_S(jnp.asarray(gamma_ref)))
    S_sh = sl.gamma_global(sl.schur_S(jnp.asarray(g_sh)))
    np.testing.assert_allclose(S_sh, S_ref, rtol=1e-11, atol=1e-11)


def test_public_sharded_schur_solve():
    """solve_schur through the public API in both mesh modes == single
    device (the reference's central distributed path, --schur)."""
    from pressurepoissonsolver_tpu.problems import get_problem, init_problem
    from pressurepoissonsolver_tpu.solver import PoissonSolver, SolveOptions

    ndev = 8
    mesh = make_mesh(ndev)
    t = refined_tree(2, 3, 1)
    h1 = DomainHierarchy(t, n=8)
    s1 = PoissonSolver(h1, SolveOptions(tol=1e-10, precondition=False))
    f1, _ = init_problem(h1.finest, get_problem("trig", 2))
    u1, res1 = s1.solve_schur(jnp.asarray(f1))
    assert int(res1.iterations) > 0

    h8 = DomainHierarchy(t, n=8, num_shards=ndev)
    f8, _ = init_problem(h8.finest, get_problem("trig", 2))
    pos, nr = _id_align(h8.finest, h1.finest)
    for comm in ("pjit", "halo"):
        s8 = PoissonSolver(
            h8, SolveOptions(tol=1e-10, precondition=False, comm=comm),
            mesh=mesh,
        )
        u8, res8 = s8.solve_schur(jnp.asarray(f8))
        np.testing.assert_allclose(
            np.asarray(u8)[:nr], np.asarray(u1)[pos], atol=1e-8
        )
        assert np.abs(np.asarray(u8)[nr:]).max() == 0.0


def test_sharded_active_set_smoothing_matches_masked():
    """Per-shard subset-compute FAC smoothing (halo engine)
    gives the same cycle as both the masked-sweep fallback and the
    single-device ActiveSmoother path, bit-for-tolerance."""
    from pressurepoissonsolver_tpu.gmg import CycleOpts, build_gmg
    from pressurepoissonsolver_tpu.parallel.halo import (
        ShardedActiveSmoother, ShardedLevel, ShardedTransfer,
    )

    ndev = 8
    mesh = make_mesh(ndev)
    # needs pass-through-heavy coarse levels for the masks to be proper
    t = refined_tree(2, 4, 2)
    opts = CycleOpts(pre_sweeps=2, fac_smoothing="active")

    # single-device reference cycle (subset-compute ActiveSmoother)
    h1 = DomainHierarchy(t, n=8)
    g1 = build_gmg(h1, opts=opts)

    # sharded cycle wrapped in the halo engine + subset smoothers
    h8 = DomainHierarchy(t, n=8, num_shards=ndev)
    g8 = build_gmg(h8, opts=opts, mesh=mesh)
    wrapped = [ShardedLevel(l, mesh) for l in g8.levels]
    g8.transfers = [
        ShardedTransfer(tr, wrapped[k], wrapped[k + 1])
        for k, tr in enumerate(g8.transfers)
    ]
    g8.levels = wrapped
    masked_active = [m for m in g8._active if isinstance(m, jnp.ndarray)]
    assert masked_active, "expected at least one masked sharded level"
    g8.attach_sharded_active()
    upgraded = [s for s in g8._asmooth if isinstance(s, ShardedActiveSmoother)]
    assert len(upgraded) == len(masked_active)

    rng = np.random.default_rng(5)
    pos, nr = _id_align(h8.finest, h1.finest)
    f1 = rng.standard_normal((h1.finest.num_patches, 8, 8))
    f8 = np.zeros((h8.finest.num_patches, 8, 8))
    f8[:nr] = f1[pos]
    out8 = np.asarray(g8.apply(jnp.asarray(f8)))
    out1 = np.asarray(g1.apply(jnp.asarray(f1)))
    np.testing.assert_allclose(out8[:nr], out1[pos], rtol=1e-12, atol=1e-12)
    assert np.abs(out8[nr:]).max(initial=0.0) == 0.0
