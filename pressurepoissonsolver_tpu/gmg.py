"""FAC geometric multigrid: inter-level transfers and V/W cycles.

A re-design of the reference's ``GMG::*`` layer
(SURVEY.md §2.7).  Transfers between a fine and a coarse
:class:`~pressurepoissonsolver_tpu.ops.level_ops.Level` are static
gather/scatter-adds driven by host-precomputed parent-slot tables — the
replacement for ``GMG::InterLevelComm``'s VecScatters
(``GMG/InterLevelComm.h:114-189``).

* Restriction (``GMG::AvgRstr``, ``GMG/AvgRstr.h:53-113``): each fine patch
  average-pools 2^D cells into one and adds the result into its orthant
  block of the parent patch; pass-through patches (their own parent,
  ``ThundereggDomGen.h:152-163``) copy through unchanged.
* Prolongation (``GMG::DrctIntp``, ``GMG/DrctIntp.h:77-113``):
  piecewise-constant injection of the parent's orthant block, added into
  the fine patch; pass-through copies.

The cycle visitors mirror ``GMG::VCycle``/``GMG::WCycle``
(``GMG/VCycle.h:44-60``, ``GMG/WCycle.h:42-67``) with the recursion
unrolled in Python so the whole cycle traces into a single XLA program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .domain import DomainHierarchy, parent_slots
from .ops.level_ops import Level, _arr_axis


@dataclass
class CycleOpts:
    """Reference ``GMG::CycleOpts`` (``GMG/CycleOpts.h:51-80``)."""

    max_levels: int = 0  # 0 = no limit
    patches_per_shard: float = 0  # stop when patches/shard drops below this
    pre_sweeps: int = 1
    post_sweeps: int = 1
    mid_sweeps: int = 1
    coarse_sweeps: int = 1
    cycle_type: str = "V"
    interpolator: str = "constant"  # "constant" (DrctIntp) | "linear" (TriLinIntp)
    # Exact coarse solve: stop the hierarchy once a level has at most this
    # many DOF and invert its assembled operator once (a single matmul per
    # cycle in place of a deep tail of tiny, latency-bound levels, and a
    # stronger coarse correction than smoothing sweeps).  The default of
    # 4096 has not been tuned on the GPU.
    coarse_direct_max_dof: int = 4096
    coarse_direct: bool = True
    # FAC active-set relaxation: classical FAC (McCormick) relaxes each
    # coarse level only on the region it is the finest representation of —
    # the newly-merged parent patches (+ ``fac_active_ring`` rings of
    # neighbors for the refinement-boundary error).  Pass-through patches
    # are identical on the finer level and were just relaxed there; on the
    # reference's pass-through-heavy meshes they are ~90-95% of every
    # coarse level, so "active" cuts most of the per-cycle smoothing work.
    # The reference relaxes everywhere (FFTBlockJacobiSmoother over the
    # whole level) — "full" reproduces that.
    fac_smoothing: str = "full"  # "full" | "active"
    fac_active_ring: int = 1
    # Per-level sweep split: coarse-level visits are latency-bound (each
    # op costs about the same regardless of level size), so trimming
    # sweeps below the finest level can cut cycle wall-clock more than it
    # weakens the correction.  0 = use pre_sweeps everywhere.
    coarse_pre_sweeps: int = 0


def _axis_matmul(M: jnp.ndarray, x: jnp.ndarray, ax: int) -> jnp.ndarray:
    """Apply an n×n matrix along array axis ``ax`` of ``x`` via broadcasting
    matmuls (no moveaxis for the two minor axes)."""
    if ax == x.ndim - 1:
        return jnp.matmul(x, M.T, precision=jax.lax.Precision.HIGHEST)
    if ax == x.ndim - 2:
        return jnp.matmul(M, x, precision=jax.lax.Precision.HIGHEST)
    moved = jnp.moveaxis(x, ax, -1)
    y = jnp.matmul(moved, M.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.moveaxis(y, -1, ax)


def _constant_prolong_matrix(n: int, half: int) -> np.ndarray:
    """n×n 0/1 matrix: fine cell i of the (half)-child reads parent cell
    ``(i + half*n)//2`` — piecewise-constant injection (``GMG::DrctIntp``)
    in matmul form."""
    W = np.zeros((n, n))
    for i in range(n):
        W[i, (i + half * n) // 2] = 1.0
    return W


def _restrict_matrix(n: int, half: int) -> np.ndarray:
    """n×n matrix accumulating a full fine-child patch line into the
    (half)-orthant of the parent line by cell averaging
    (``GMG::AvgRstr``): parent cell ``j + half*n/2`` gets
    ``(fine[2j] + fine[2j+1]) / 2`` per axis."""
    R = np.zeros((n, n))
    for j in range(n // 2):
        J = j + half * (n // 2)
        R[J, 2 * j] = 0.5
        R[J, 2 * j + 1] = 0.5
    return R


def _linear_prolong_matrix(n: int, half: int) -> np.ndarray:
    """n×n matrix mapping a parent patch's 1D cell line to the fine cells of
    its lower (half=0) or upper (half=1) child, by cell-centered linear
    interpolation with one-sided extrapolation at patch edges.

    Reproduces the reference's trilinear-prolongation coefficient tables
    (``GMG/TriLinIntp.cpp:105-673``): interior weights (3/4, 1/4) per axis
    — e.g. the 3D center stencil 27/64 = (3/4)^3 — and edge weights
    (5/4, -1/4) — e.g. the exterior-face value 45/64 = (5/4)(3/4)(3/4).
    """
    W = np.zeros((n, n))
    start = half * (n // 2)
    for i in range(n):
        c = start + i // 2
        d = 1 if (i % 2 == 1) else -1
        j = c + d
        if 0 <= j < n:
            W[i, c] += 0.75
            W[i, j] += 0.25
        else:
            W[i, c] += 1.25
            W[i, c - d] += -0.25
    return W


class Transfer:
    """Fine<->coarse transfer tables between two levels.

    ``prolong_mode``: ``"constant"`` — piecewise-constant injection
    (reference ``GMG::DrctIntp``, the factory default); ``"linear"`` —
    cell-centered bi/trilinear prolongation (reference ``GMG::TriLinIntp``).
    """

    def __init__(self, fine: Level, coarse: Level, prolong_mode: str = "constant"):
        self.fine = fine
        self.coarse = coarse
        self.prolong_mode = prolong_mode
        D, n = fine.D, fine.n
        self.D, self.n = D, n
        self._cells = n**D
        self._wlin = [
            jnp.asarray(_linear_prolong_matrix(n, h)) for h in range(2)
        ]
        self._wconst = [
            jnp.asarray(_constant_prolong_matrix(n, h)) for h in range(2)
        ]
        self._wrstr = [jnp.asarray(_restrict_matrix(n, h)) for h in range(2)]
        # f32 fast path: per-orthant transfers in Kronecker form — one
        # [n^2, n^2] matmul on flat operands (2D), or a (y,x) Kronecker
        # matmul plus a z contraction (3D); the f64 path keeps the
        # per-axis form.
        from .ops.level_ops import kron_max_n

        self._use_kron = (
            np.dtype(fine.dtype) == np.dtype(np.float32)
            and D in (2, 3)
            and n <= kron_max_n()
        )
        if self._use_kron:
            rmats = [_restrict_matrix(n, h) for h in range(2)]
            pmats = (
                [_linear_prolong_matrix(n, h) for h in range(2)]
                if prolong_mode == "linear"
                else [_constant_prolong_matrix(n, h) for h in range(2)]
            )
            self._Wr, self._Wp = [], []
            for o in range(1 << D):
                kr = np.kron(rmats[(o >> 1) & 1], rmats[o & 1]).T
                kp = np.kron(pmats[(o >> 1) & 1], pmats[o & 1]).T
                if D == 2:
                    self._Wr.append(jnp.asarray(kr, dtype=jnp.float32))
                    self._Wp.append(jnp.asarray(kp, dtype=jnp.float32))
                else:
                    self._Wr.append((
                        jnp.asarray(kr, dtype=jnp.float32),
                        jnp.asarray(rmats[(o >> 2) & 1], dtype=jnp.float32),
                    ))
                    self._Wp.append((
                        jnp.asarray(kp, dtype=jnp.float32),
                        jnp.asarray(pmats[(o >> 2) & 1], dtype=jnp.float32),
                    ))
        pslots = parent_slots(fine.pl, coarse.pl)
        passthrough = fine.pl.orth_on_parent < 0
        orth = fine.pl.orth_on_parent

        # static per-orthant groups (host index arrays)
        self._groups = []  # (orthant, fine_slots, parent_slots)
        for o in range(1 << D):
            sel = np.where((~passthrough) & (orth == o))[0]
            if len(sel):
                self._groups.append(
                    (o, jnp.asarray(sel), jnp.asarray(pslots[sel]))
                )
        # pass-through copies; padded dummy patches (parent slot -1) are
        # excluded from both transfer directions and stay zero
        sel = np.where(passthrough & (pslots >= 0))[0]
        self._pt_fine = jnp.asarray(sel) if len(sel) else None
        self._pt_parent = jnp.asarray(pslots[sel]) if len(sel) else None

        # --- gather-form tables (row gathers, no element-granular device
        # scatter-adds) ------------------------------------------------------
        Pf, Pc = fine.P, coarse.P
        # restriction: per coarse patch, the fine slot of each orthant child
        # (Pf = zero-pad row) and the pass-through fine slot
        child_slot = np.full((Pc, 1 << D), Pf, dtype=np.int32)
        pt_slot = np.full(Pc, Pf, dtype=np.int32)
        for i in range(Pf):
            ps = pslots[i]
            if ps < 0:
                continue  # padded dummy patch
            if passthrough[i]:
                pt_slot[ps] = i
            else:
                child_slot[ps, orth[i]] = i
        self._child_slot = jnp.asarray(child_slot)
        self._pt_slot = jnp.asarray(pt_slot)
        # parent-compact restriction: on pass-through-heavy coarse levels
        # most child_slot rows are padding — pooling over just the parent
        # rows and routing back with one row gather skips the padded
        # matmul work.  Worth the two extra ops only when parents are a
        # minority and the level is big enough not to be latency-bound.
        parents = np.where((child_slot < Pf).any(axis=1))[0]
        self._r_parents = None
        if Pc >= 256 and len(parents) < Pc // 2:
            self._r_parents = jnp.asarray(parents)
            self._r_child_slot = jnp.asarray(child_slot[parents])
            inv = np.full(Pc, len(parents), dtype=np.int32)  # pad row = zeros
            inv[parents] = np.arange(len(parents), dtype=np.int32)
            self._r_inv = jnp.asarray(inv)
        # prolongation: the concat order of (orthant groups..., passthrough)
        # rows, inverted so one row gather re-scatters blocks to fine slots
        order = [np.asarray(fsel) for _, fsel, _ in self._groups]
        if self._pt_fine is not None:
            order.append(np.asarray(self._pt_fine))
        order = np.concatenate(order) if order else np.zeros(0, dtype=np.int64)
        inv = np.full(Pf, len(order), dtype=np.int32)  # pad row = zeros
        inv[order] = np.arange(len(order), dtype=np.int32)
        self._prolong_inv = jnp.asarray(inv)

    def _quadrant_index(self, o: int):
        """Array-index tuple selecting orthant ``o``'s block of a coarse
        patch (reference ``AvgRstr.h:66-72``: bit a of ``o`` set = upper
        half of axis a)."""
        D, n = self.D, self.n
        idx = [slice(None)]  # patch axis
        for arr in range(1, D + 1):
            a = D - arr  # spatial axis for this array axis
            if (o >> a) & 1:
                idx.append(slice(n // 2, n))
            else:
                idx.append(slice(0, n // 2))
        return tuple(idx)

    def _orthant_apply(self, blk_flat: jnp.ndarray, o: int, kron_mats,
                       axis_mats) -> jnp.ndarray:
        """Apply the orthant-``o`` transfer matrices to flat ``[R, n^D]``
        rows: Kronecker matmuls on the f32 path, per-axis matmuls (exact
        summation structure) otherwise."""
        D, n = self.D, self.n
        hp = jax.lax.Precision.HIGHEST
        if self._use_kron:
            if D == 2:
                return jnp.dot(blk_flat, kron_mats[o].astype(blk_flat.dtype),
                               precision=hp)
            Wyx, Rz = kron_mats[o]
            x3 = blk_flat.reshape(-1, n, n * n)
            y = jnp.einsum("pwl,zw->pzl", x3, Rz.astype(blk_flat.dtype),
                           precision=hp)
            y = jnp.matmul(y, Wyx.astype(blk_flat.dtype), precision=hp)
            return y.reshape(blk_flat.shape[0], -1)
        blk = blk_flat.reshape((-1,) + (n,) * D)
        for a in range(D):
            M = axis_mats[(o >> a) & 1].astype(blk.dtype)
            blk = _axis_matmul(M, blk, 1 + (D - 1 - a))
        return blk.reshape(blk_flat.shape[0], -1)

    def restrict(self, fine_u: jnp.ndarray) -> jnp.ndarray:
        """Cell-averaging restriction into a new coarse-level vector.

        Matmul form: per orthant, gather the full child patches (as flat
        ``[.., n^D]`` rows) by the
        coarse-side child table and accumulate them through the
        averaging-placement matrices."""
        D, n = self.D, self.n
        Pf = fine_u.shape[0]
        cells = self._cells
        fine_flat = jnp.concatenate(
            [fine_u.reshape(Pf, cells),
             jnp.zeros((1, cells), dtype=fine_u.dtype)], axis=0
        )
        # compact form only off-mesh: its row gathers are shard-arbitrary
        compact = (
            self._r_parents is not None
            and getattr(self.coarse, "_psh", None) is None
        )
        child_slot = self._r_child_slot if compact else self._child_slot
        assembled = None
        for o in range(1 << D):
            block = self._orthant_apply(
                fine_flat[child_slot[:, o]], o,
                self._Wr if self._use_kron else None, self._wrstr,
            )
            assembled = block if assembled is None else assembled + block
        if compact:
            pad = jnp.zeros((1, cells), dtype=assembled.dtype)
            assembled = jnp.concatenate([assembled, pad], axis=0)[self._r_inv]
        out = (assembled + fine_flat[self._pt_slot]).reshape(
            (-1,) + fine_u.shape[1:]
        )
        return self.coarse._constrain_p(out)

    def prolong_add(self, coarse_u: jnp.ndarray, fine_u: jnp.ndarray) -> jnp.ndarray:
        """Prolongation (constant or linear), added into ``fine_u``.

        Gather form: compute each orthant group's blocks, stack them with the
        pass-through rows, and route rows to fine slots with one precomputed
        (flat) row gather — no scatter-adds."""
        cells = self._cells
        cflat = coarse_u.reshape(coarse_u.shape[0], cells)
        axis_mats = self._wlin if self.prolong_mode == "linear" else self._wconst
        parts = [
            self._orthant_apply(
                cflat[psel], o, self._Wp if self._use_kron else None, axis_mats
            )
            for o, _, psel in self._groups
        ]
        if self._pt_fine is not None:
            parts.append(cflat[self._pt_parent])
        if not parts:
            return fine_u
        stacked = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        zrow = jnp.zeros((1, cells), dtype=stacked.dtype)
        stacked_pad = jnp.concatenate([stacked, zrow], axis=0)
        routed = stacked_pad[self._prolong_inv].reshape(fine_u.shape)
        return self.fine._constrain_p(fine_u + routed)


def _expand_ring(pl, active: np.ndarray, rings: int) -> np.ndarray:
    """Expand a patch set by ``rings`` rings of face neighbors."""
    active = active.copy()
    for _ in range(rings):
        cur = np.where(active)[0]
        nbrs = pl.nbr_slot[cur].ravel()
        fnbrs = pl.fine_nbr_slots[cur].ravel()
        active[nbrs[nbrs >= 0]] = True
        active[fnbrs[fnbrs >= 0]] = True
    return active


def _fac_active_mask(transfer: Transfer, ring: int):
    """Coarse-level patches to relax under FAC active-set smoothing: the
    parents newly merged from the finer level, expanded by ``ring`` rings
    of face neighbors (the refinement-boundary zone).  Returns ``None``
    when every patch is active (mask would be a no-op)."""
    fine_pl, coarse_pl = transfer.fine.pl, transfer.coarse.pl
    pslots = parent_slots(fine_pl, coarse_pl)
    passthrough = fine_pl.orth_on_parent < 0
    active = np.zeros(coarse_pl.num_patches, dtype=bool)
    sel = pslots[(~passthrough) & (pslots >= 0)]
    active[sel] = True
    active = _expand_ring(coarse_pl, active, ring)
    if active.all():
        return None
    return active


class GMGCycle:
    """A V- or W-cycle over a level hierarchy, applied as ``u = M f``.

    Matches ``GMG::Cycle::apply`` (``GMG/Cycle.h:34-127``): the input is a
    residual-style RHS; the initial guess is zero on every level.
    """

    def __init__(self, levels: List[Level], transfers: List[Transfer], opts: CycleOpts):
        assert len(transfers) == len(levels) - 1
        self.levels = levels
        self.transfers = transfers
        self.opts = opts
        self._coarse_inv = None
        if opts.coarse_direct and (
            levels[-1].P * levels[-1].pl.cells_per_patch <= opts.coarse_direct_max_dof
        ):
            self._build_coarse_direct()
        # FAC active-set relaxation state, one entry per coarse level:
        # None = relax all; an ActiveSmoother = subset-compute sweeps; a
        # mask array = masked-update sweeps (sharded engines, where subset
        # gathers would cross shards); "skip" = nothing to relax.
        self._active = [None] * len(levels)
        self._asmooth = [None] * len(levels)
        self._aapply = [None] * len(levels)
        if opts.fac_smoothing == "active":
            from .ops.level_ops import ActiveSmoother, Level as _L

            for k in range(1, len(levels)):
                mask = _fac_active_mask(transfers[k - 1], opts.fac_active_ring)
                if mask is None:
                    continue
                if not mask.any():
                    self._active[k] = "skip"
                elif isinstance(levels[k], _L) and levels[k].mesh is None:
                    self._asmooth[k] = ActiveSmoother(levels[k], mask)
                    self._active[k] = self._asmooth[k]._mask
                    # residual apply on nbr(active) only: after active-set
                    # smoothing u vanishes off the active set, so every
                    # nonzero row of A u lies within one ring of it
                    self._aapply[k] = ActiveSmoother(
                        levels[k],
                        _expand_ring(levels[k].pl, mask, 1),
                        build_solver=False,
                    )
                else:
                    D = levels[k].D
                    self._active[k] = jnp.asarray(mask.reshape((-1,) + (1,) * D))

    def attach_sharded_active(self) -> None:
        """Upgrade the sharded active-set fallback (masked full sweeps) to
        per-shard subset smoothers — call after the levels were wrapped in
        halo ``ShardedLevel``s."""
        from .parallel.halo import ShardedActiveSmoother, ShardedLevel

        for k in range(1, len(self.levels)):
            mask = self._active[k]
            if not isinstance(self.levels[k], ShardedLevel):
                continue
            if mask is None or isinstance(mask, str):
                continue
            m = np.asarray(mask).reshape(-1).astype(bool)
            self._asmooth[k] = ShardedActiveSmoother(self.levels[k], m)
            ring = _expand_ring(self.levels[k].pl, m.copy(), 1)
            self._aapply[k] = ShardedActiveSmoother(self.levels[k], ring)

    def _build_coarse_direct(self) -> None:
        from .matrix import assemble_composite

        lvl = self.levels[-1]
        A = assemble_composite(lvl.pl).toarray()
        # Neumann problems have the constant nullspace -> pseudo-inverse
        # (padded dummy patches are Dirichlet-walled and invertible, so the
        # nullspace test looks at real patches only)
        nr = lvl.pl.real_patches
        phys = lvl.pl.nbr_type[:nr] == 0
        all_neumann = bool(np.asarray(lvl.pl.neumann)[:nr][phys].all())
        Ainv = np.linalg.pinv(A) if all_neumann else np.linalg.inv(A)
        self._coarse_inv = jnp.asarray(np.asarray(Ainv, dtype=np.dtype(lvl.dtype)))

    def apply(self, f: jnp.ndarray) -> jnp.ndarray:
        return self._visit(0, f)

    def _visit(self, k: int, f: jnp.ndarray) -> jnp.ndarray:
        lvl = self.levels[k]
        opts = self.opts
        if k == len(self.levels) - 1:
            if self._coarse_inv is not None:
                sol = self._coarse_inv.astype(f.dtype) @ f.ravel()
                return sol.reshape(f.shape)
            if opts.coarse_sweeps <= 0:
                return lvl.zeros().astype(f.dtype)
            u = lvl.smooth_zero(f)
            for _ in range(opts.coarse_sweeps - 1):
                u = lvl.smooth(f, u)
            return u
        mask = self._active[k]
        pre = opts.pre_sweeps if (k == 0 or opts.coarse_pre_sweeps <= 0) \
            else opts.coarse_pre_sweeps
        if pre <= 0 or isinstance(mask, str):  # "skip"
            u = lvl.zeros().astype(f.dtype)
        elif self._asmooth[k] is not None:
            u = self._asmooth[k].smooth_zero(f)
            for _ in range(pre - 1):
                u = self._smooth(k, f, u)
        else:
            u = lvl.smooth_zero(f)
            if mask is not None:
                u = jnp.where(mask, u, jnp.zeros((), dtype=u.dtype))
            for _ in range(pre - 1):
                u = self._smooth(k, f, u)
        if opts.cycle_type == "W":
            u = self._w_recurse(k, f, u)
        else:
            u = self._correct(k, f, u, first=True)
        for _ in range(opts.post_sweeps):
            u = self._smooth(k, f, u)
        return u

    def _residual(self, k: int, f, u, first: bool):
        """``f - A u`` on level ``k``; on the first pass of a level visit
        ``u`` is zero off the active set, so the residual apply runs on
        nbr(active) only (or is ``f`` exactly when nothing was relaxed)."""
        lvl = self.levels[k]
        mask = self._active[k]
        pre = self.opts.pre_sweeps if (k == 0 or self.opts.coarse_pre_sweeps <= 0) \
            else self.opts.coarse_pre_sweeps
        if first and (isinstance(mask, str) or pre <= 0):
            return f  # u = 0: nothing was relaxed on this level yet
        if first and self._aapply[k] is not None:
            return f - self._aapply[k].apply_scattered(u)
        return f - lvl.apply(u)

    def _correct(self, k: int, f, u, first: bool):
        """One coarse-grid correction: restrict the residual, visit the
        coarser level, prolong the correction back (``GMG/Cycle.h:56-80``)."""
        r = self._residual(k, f, u, first)
        fc = self.transfers[k].restrict(r)
        uc = self._visit(k + 1, fc)
        return self.transfers[k].prolong_add(uc, u)

    def _w_recurse(self, k: int, f, u):
        """The W-cycle's two coarse visits, rolled into a length-2
        ``lax.scan`` so the coarser subtree is traced ONCE per level pair
        (``GMG/WCycle.h:30-83`` visits level k 2^k times — unrolled, that
        program grows exponentially with depth and blows the compile
        budget at bench scale; scanned, program size stays linear, V ≈ W).

        The first pass differs from the second (active-set residual
        short-cuts valid only while u vanishes off the active set, and
        mid-sweeps run only *between* the visits), so the scan body
        branches on the iteration index with ``lax.cond`` — around the
        residual and the mid-smooth only, so the coarse visit itself is
        shared by both passes."""
        opts = self.opts

        def body(carry, it):
            uu = carry
            r = jax.lax.cond(
                it == 0,
                lambda v: self._residual(k, f, v, first=True),
                lambda v: self._residual(k, f, v, first=False),
                uu,
            )
            fc = self.transfers[k].restrict(r)
            uc = self._visit(k + 1, fc)  # ONE trace of the coarser subtree
            uu = self.transfers[k].prolong_add(uc, uu)

            def with_mid(v):
                for _ in range(opts.mid_sweeps):
                    v = self._smooth(k, f, v)
                return v

            uu = jax.lax.cond(it == 0, with_mid, lambda v: v, uu)
            return uu, None

        u, _ = jax.lax.scan(body, u, jnp.arange(2))
        return u

    def _smooth(self, k: int, f: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """One block-Jacobi sweep on level ``k``; under FAC active-set
        smoothing only the active patches are updated."""
        if self._asmooth[k] is not None:
            return self._asmooth[k].smooth(f, u)
        mask = self._active[k]
        if mask is None:
            return self.levels[k].smooth(f, u)
        if isinstance(mask, str):  # "skip": nothing to relax on this level
            return u
        return jnp.where(mask, self.levels[k].smooth(f, u), u)


def build_gmg(
    hierarchy: DomainHierarchy,
    opts: Optional[CycleOpts] = None,
    dtype=jnp.float64,
    num_shards: int = 1,
    mesh=None,
) -> GMGCycle:
    """Build the level stack + transfers (reference
    ``GMG::CycleFactory2d/3d::getCycle``, ``GMG/CycleFactory2d.cpp:69-134``):
    stop adding levels when ``max_levels`` is reached or the patch count
    per shard falls below ``patches_per_shard``.  With ``mesh`` set, every
    level's ops run patch-sharded over the mesh."""
    opts = opts or CycleOpts()
    if mesh is not None:
        num_shards = max(num_shards, int(np.prod(mesh.devices.shape)))
    levels: List[Level] = [Level(hierarchy[0], dtype=dtype)]
    transfers: List[Transfer] = []
    for k in range(1, len(hierarchy)):
        if opts.max_levels > 0 and len(levels) >= opts.max_levels:
            break
        pl = hierarchy[k]
        if pl.num_patches / num_shards < opts.patches_per_shard:
            break
        if (
            opts.coarse_direct
            and levels[-1].P * levels[-1].pl.cells_per_patch
            <= opts.coarse_direct_max_dof
        ):
            break  # current coarsest is small enough for a direct solve
        lvl = Level(pl, dtype=dtype)
        transfers.append(Transfer(levels[-1], lvl, prolong_mode=opts.interpolator))
        levels.append(lvl)
    if mesh is not None:
        for lvl in levels:
            lvl.set_mesh(mesh)
    return GMGCycle(levels, transfers, opts)
