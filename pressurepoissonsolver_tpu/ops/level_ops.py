"""Batched per-level device operations.

One :class:`Level` holds the device-resident index tables and spectral data
for a single refinement level, and exposes the four core linear maps as
pure, jittable array functions batched over the leading patch axis:

* ``interpolate(u) -> gamma`` — trace interpolation onto the interface
  vector (reference ``SchurHelper::interpolateToInterface`` +
  ``updateInterfaceDist``; a single fused gather/scatter-add here).
* ``apply(u) -> A u`` — the composite-grid operator (reference
  ``SchurHelper::apply``, ``SchurHelper.h:360-376``).
* ``patch_solve(f, gamma) -> u`` — exact per-patch solves by DST/DCT
  diagonalization, batched as matmuls (reference
  ``FftwPatchSolver::solve`` / ``DftPatchSolver::solve``).
* ``smooth(f, u) -> u'`` — one FFT block-Jacobi sweep (reference
  ``SchurHelper::solveWithSolution``, ``SchurHelper.h:318-331``).

Array layout: patch fields are ``[P, (nz,) ny, nx]`` with x fastest,
matching the reference's stride-1-in-x layout; face vectors are C-order
flattenings of the remaining axes (lowest axis fastest).

All data defaults to float64 (required for 1e-10 residual targets); pass
``dtype=jnp.float32`` for a mixed-precision preconditioner level.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import iface as iface_mod
from ..domain import PatchLevel
from . import stencil_gpu
from . import transforms as tr


def _arr_axis(D: int, ref_axis: int) -> int:
    """Array axis (in a [P, ...] patch array) for spatial axis ``ref_axis``."""
    return 1 + (D - 1 - ref_axis)


def kron_max_n() -> int:
    """Largest patch size whose f32 spectral solves / GMG transfers use the
    flat Kronecker form: one [n^2, n^2] matmul on flat [P, n^2] rows in
    place of a chain of per-axis matmuls with an n-wide minor axis.  The
    per-cell flop cost of the Kronecker form grows as n^2, so it is cut off
    above this size.  The default of 16 has not been tuned on the GPU;
    PPS_KRON_MAX_N overrides it."""
    return int(os.environ.get("PPS_KRON_MAX_N", "16"))


def extract_faces(u: jnp.ndarray, D: int, n: int, depth: int = 1) -> jnp.ndarray:
    """Boundary-cell traces: ``[P, 2D*depth, m]`` with ``m = n**(D-1)``.

    ``depth > 1`` also extracts faces ``d`` cells inward (row order:
    ``side * depth + d``) — sources of the higher-order 2D closures."""
    P = u.shape[0]
    faces = []
    for a in range(D):
        ax = _arr_axis(D, a)
        for d in range(depth):
            faces.append(jnp.take(u, d, axis=ax).reshape(P, -1))
        for d in range(depth):
            faces.append(jnp.take(u, n - 1 - d, axis=ax).reshape(P, -1))
    return jnp.stack(faces, axis=1)


@dataclass(frozen=True)
class _SolveGroup:
    """Static metadata of one BC-homogeneous patch-solver batch."""

    start: int
    stop: int
    fwd_kinds: Tuple[int, ...]  # per spatial axis
    inv_kinds: Tuple[int, ...]
    pin_dc: bool  # all-Neumann nullspace pin (FftwPatchSolver.h:197)


@dataclass
class _SolverTables:
    """Spectral patch-solve data for a (subset of a) level, BC-sorted."""

    perm: jnp.ndarray
    inv_perm: jnp.ndarray
    identity_perm: bool
    # eigen-denominators in factored per-axis form: ``lam_tab [K, n]``
    # holds the distinct axis eigenvalue rows (K = #(BC delta, h) pairs —
    # dozens, not DOF) and ``lam_idx [Ps, D]`` maps each sorted patch
    # slot's axes into it.  The dense ``[Ps, *ns]`` denominator is
    # materialized on the fly by ``_denom_of`` as a broadcast-sum that XLA
    # fuses into the eigen-divide.  A dense form would be O(DOF) *per
    # level*, embedded as an HLO literal by JAX's lowering, and read from
    # device memory on every smooth although it is recomputable.
    lam_tab: jnp.ndarray  # [K, n] (f64: the per-cell sum is computed in
    # f64 and cast to the table dtype AFTER summing — bit-identical to
    # the old dense-f64-then-cast denominators; summing cast-f32 rows
    # instead cost 2 extra inner iterations at the bench noise floor)
    lam_idx: jnp.ndarray  # [Ps, D] int32 into lam_tab
    groups: List[_SolveGroup]
    tmats: dict  # transform kind -> [n, n] matrix
    # f32 fast path: per group, the forward/inverse transforms in Kronecker
    # form — 2D: (W1 [n^2,n^2], W2) so a whole patch solve is two matmuls
    # on perfectly lane-tiled [Ps, n^2] operands; 3D: (Wyx1, Wyx2, Tz1,
    # Tz2) — the (y,x) pair as one [n^2,n^2] matmul plus a z-axis
    # contraction.  The transforms only serve the smoother/preconditioner,
    # where default-precision matmuls (TF32 on the GPU) are plenty.
    kron: Optional[list] = None
    # target dtype of the materialized denominator (see lam_tab note)
    denom_dtype: object = None


def _build_solver_tables(pl: PatchLevel, dtype, slots: np.ndarray) -> _SolverTables:
    """BC-grouped spectral solver tables for patch slots ``slots`` (the
    reference's plan cache keyed on (neumann bits, h),
    ``FftwPatchSolver.h:33-47``, generalized to an arbitrary patch subset
    for the FAC active-set smoother)."""
    D, n = pl.D, pl.n
    Ps = len(slots)
    keys = []
    for p in slots:
        keys.append(tuple(
            tr.axis_transforms(bool(pl.neumann[p, 2 * a]), bool(pl.neumann[p, 2 * a + 1]))[:2]
            for a in range(D)
        ))
    order = sorted(range(Ps), key=lambda i: (keys[i], i))
    perm = np.array(order, dtype=np.int64)
    inv_perm = np.empty(Ps, dtype=np.int64)
    inv_perm[perm] = np.arange(Ps)

    lam_keys: dict = {}
    lam_rows: List[np.ndarray] = []
    lam_idx = np.zeros((Ps, D), dtype=np.int32)
    for i, si in enumerate(order):
        p = slots[si]
        for a in range(D):
            delta = tr.axis_transforms(
                bool(pl.neumann[p, 2 * a]), bool(pl.neumann[p, 2 * a + 1])
            )[2]
            hkey = (delta, float(pl.spacings[p, a]))
            k = lam_keys.get(hkey)
            if k is None:
                k = lam_keys[hkey] = len(lam_rows)
                lam_rows.append(tr.axis_eigenvalues(n, hkey[1], delta))
            lam_idx[i, a] = k
    lam_tab = np.stack(lam_rows) if lam_rows else np.zeros((1, n))

    groups: List[_SolveGroup] = []
    start = 0
    while start < Ps:
        stop = start
        k = keys[order[start]]
        while stop < Ps and keys[order[stop]] == k:
            stop += 1
        all_neu = bool(np.all(pl.neumann[slots[order[start]]]))
        groups.append(_SolveGroup(
            start=start, stop=stop,
            fwd_kinds=tuple(kk[0] for kk in k),
            inv_kinds=tuple(kk[1] for kk in k),
            pin_dc=all_neu,
        ))
        start = stop
    kinds_used = sorted({kk for g in groups for kk in g.fwd_kinds + g.inv_kinds})
    tmats = {
        kk: jnp.asarray(np.asarray(tr.transform_matrix(kk, n),
                                   dtype=np.dtype(dtype)))
        for kk in kinds_used
    }
    kron = None
    if dtype == jnp.float32 and D in (2, 3) and n <= kron_max_n():
        scale = (2.0 / n) ** D
        kron = []
        for g in groups:
            Tf = [tr.transform_matrix(k, n) for k in g.fwd_kinds]
            Ti = [tr.transform_matrix(k, n) for k in g.inv_kinds]
            W1 = np.kron(Tf[1], Tf[0]).T  # (y, x) pair, row-major flat
            W2 = np.kron(Ti[1], Ti[0]).T
            if D == 2:
                kron.append((
                    jnp.asarray(np.asarray(W1, dtype=np.dtype(dtype))),
                    jnp.asarray(np.asarray(W2 * scale, dtype=np.dtype(dtype))),
                ))
            else:
                kron.append((
                    jnp.asarray(np.asarray(W1, dtype=np.dtype(dtype))),
                    jnp.asarray(np.asarray(W2 * scale, dtype=np.dtype(dtype))),
                    jnp.asarray(np.asarray(Tf[2], dtype=np.dtype(dtype))),
                    jnp.asarray(np.asarray(Ti[2], dtype=np.dtype(dtype))),
                ))
    return _SolverTables(
        perm=jnp.asarray(perm),
        inv_perm=jnp.asarray(inv_perm),
        identity_perm=bool(np.all(perm == np.arange(Ps))),
        lam_tab=jnp.asarray(lam_tab),  # f64
        denom_dtype=dtype,
        lam_idx=jnp.asarray(lam_idx),
        groups=groups,
        tmats=tmats,
        kron=kron,
    )


def _face_pad_sum(
    gf: jnp.ndarray,
    h2inv: jnp.ndarray,
    D: int,
    n: int,
    dtype,
) -> jnp.ndarray:
    """``sum_sides h^-2 * pad(gf_face)`` as one fused elementwise pass.

    The pad-spread form adds face terms into a full field in one fused
    elementwise pass; the ``.at[].add`` slice-update form costs a
    full-array copy per side."""
    P = gf.shape[0]
    add = None
    for a in range(D):
        ax = _arr_axis(D, a)
        h2i = h2inv[:, a].astype(dtype).reshape((P,) + (1,) * D)
        for side, pos in ((2 * a, 0), (2 * a + 1, n - 1)):
            face = gf[:, side].reshape((P,) + (n,) * (D - 1))
            widths = [(0, 0)] * (D + 1)
            widths[ax] = (pos, n - 1 - pos)
            term = h2i * jnp.pad(jnp.expand_dims(face, ax), widths)
            add = term if add is None else add + term
    return add


def _fold_faces_flat(
    fc: jnp.ndarray,
    gf: jnp.ndarray,
    h2inv: jnp.ndarray,
    D: int,
    n: int,
) -> jnp.ndarray:
    """``f_slice -= 2/h^2 * gf`` on every face
    (``StarPatchOp::addInterfaceToRHS``, ``StarPatchOp.h:185-203``), as a
    fused pad-spread."""
    add = _face_pad_sum(gf, h2inv, D, n, fc.dtype)
    return fc - 2.0 * add if add is not None else fc


def _star_stencil(
    u: jnp.ndarray,
    gf: jnp.ndarray,
    ghost_coef: jnp.ndarray,
    h2inv: jnp.ndarray,
    D: int,
    n: int,
) -> jnp.ndarray:
    """Batched star-stencil apply with explicit face traces ``gf[P, 2D, m]``
    and per-patch ghost closures (``StarPatchOp.h:28-184``)."""
    P = u.shape[0]
    face_shape = (P,) + (n,) * (D - 1)
    out = jnp.zeros_like(u)
    for a in range(D):
        ax = _arr_axis(D, a)
        u_lo = jnp.take(u, 0, axis=ax)
        u_hi = jnp.take(u, n - 1, axis=ax)
        c_lo = ghost_coef[:, 2 * a].reshape((P,) + (1,) * (D - 1))
        c_hi = ghost_coef[:, 2 * a + 1].reshape((P,) + (1,) * (D - 1))
        ghost_lo = c_lo * u_lo + 2.0 * gf[:, 2 * a].reshape(face_shape)
        ghost_hi = c_hi * u_hi + 2.0 * gf[:, 2 * a + 1].reshape(face_shape)
        lo = jnp.concatenate(
            [jnp.expand_dims(ghost_lo, ax), jax.lax.slice_in_dim(u, 0, n - 1, axis=ax)],
            axis=ax,
        )
        hi = jnp.concatenate(
            [jax.lax.slice_in_dim(u, 1, n, axis=ax), jnp.expand_dims(ghost_hi, ax)],
            axis=ax,
        )
        h2i = h2inv[:, a].reshape((P,) + (1,) * D)
        out = out + (lo - 2.0 * u + hi) * h2i
    return out


def _stencil(u, gf, ghost_coef, h2inv, D: int, n: int, fused: bool):
    """The star stencil: the fused GPU kernel (``ops/stencil_gpu.py``) when
    ``fused`` and the kernel covers the case, else ``_star_stencil``."""
    if fused and stencil_gpu.supported(D, n, u.dtype):
        return stencil_gpu.star_stencil_2d(u, gf, ghost_coef, h2inv)
    return _star_stencil(u, gf, ghost_coef, h2inv, D, n)


@dataclass
class _ContribPipeline:
    """Trace-interpolation pipeline, gather-minimal form.

    Scalar-weighted contributions (normal/c2c — the bulk) are stored
    interface-major, padded to a uniform count ``Ks``, so the interface
    reduction is a fused multiply + reshape-sum with **no** reduction
    gather; the matmul contributions (refinement-boundary closures, in
    true f32 — reduced-precision matmul passes such as TF32 keep ~3
    digits, which the 2/h^2 ghost closure amplifies into O(1e-3) operator
    error) run case-sorted on their own compact interface set and are
    added back with one padded row gather.  Every gather is a rank-2 row
    gather on the flattened ``[P*S2f, m]`` face table."""

    num_ifaces: int
    Ks: int
    idx_s: jnp.ndarray  # [NIf*Ks] flat face-row ids (pad -> zero row)
    w_s: jnp.ndarray  # [NIf, Ks, 1] scalar weights (0 on pads)
    idx_m: Optional[jnp.ndarray]  # [Cm+1] flat face-row ids (last -> zero row)
    mm_W: Optional[jnp.ndarray]  # [m, ncase_m*m] all case templates stacked
    mm_ncase: int
    Km: int
    mm_gather: Optional[jnp.ndarray]  # [NIfm*Km] -> r*ncase+case (pad -> Cm*ncase)
    mm_inv: Optional[jnp.ndarray]  # [NIf] -> compact mm row (pad -> NIfm)

    def interpolate(self, faces: jnp.ndarray, m: int) -> jnp.ndarray:
        """gamma[NIf, m] from per-patch face traces [P, 2D*depth, m]."""
        P, S2f = faces.shape[0], faces.shape[1]
        ffp = jnp.concatenate(
            [faces.reshape(P * S2f, m), jnp.zeros((1, m), dtype=faces.dtype)],
            axis=0,
        )
        gs = ffp[self.idx_s].reshape(self.num_ifaces, self.Ks, m)
        gamma = jnp.sum(gs * self.w_s.astype(faces.dtype), axis=1)
        if self.idx_m is not None:
            # refinement-boundary templates: ALL case templates in ONE
            # [Cm, m] @ [m, ncase*m] matmul in true f32 (a per-row einsum
            # lowers to tiny batched matvecs; reduced-precision passes cost
            # ~3 digits that the 2/h^2 ghost closure amplifies into O(1e-3)
            # operator error).  The per-row case selection is folded into
            # the placement gather (row r, case k -> r*ncase + k); the
            # last idx_m entry reads the zero face row, so row Cm*ncase is
            # a guaranteed-zero pad with no extra concat.
            gm = ffp[self.idx_m]  # [Cm+1, m]
            vals = jnp.matmul(
                gm, self.mm_W.astype(faces.dtype),
                precision=jax.lax.Precision.HIGHEST,
            ).reshape((gm.shape[0]) * self.mm_ncase, m)
            sums = vals[self.mm_gather].reshape(-1, self.Km, m).sum(axis=1)
            sp = jnp.concatenate(
                [sums, jnp.zeros((1, m), dtype=sums.dtype)], axis=0
            )
            gamma = gamma + sp[self.mm_inv]
        return gamma


def _build_contrib_pipeline(
    contrib_patch: np.ndarray,
    contrib_side: np.ndarray,
    contrib_case: np.ndarray,
    contrib_iface: np.ndarray,
    num_ifaces: int,
    case_T: np.ndarray,
    case_scalar: list,
    dtype,
    n_face_rows: int,
    num_src_patches: int,
) -> _ContribPipeline:
    C = len(contrib_patch)
    flat = contrib_patch.astype(np.int64) * n_face_rows + contrib_side
    pad_row = num_src_patches * n_face_rows  # the appended zero row
    is_mm = np.array([case_scalar[int(k)] is None for k in contrib_case], dtype=bool)
    # scalar part: interface-major, padded to uniform Ks
    by_if = [[] for _ in range(num_ifaces)]
    for c in np.where(~is_mm)[0]:
        by_if[int(contrib_iface[c])].append(c)
    Ks = max((len(v) for v in by_if), default=1) or 1
    idx_s = np.full((num_ifaces, Ks), pad_row, dtype=np.int32)
    w_s = np.zeros((num_ifaces, Ks, 1))
    for i, v in enumerate(by_if):
        for k, c in enumerate(v):
            idx_s[i, k] = flat[c]
            w_s[i, k, 0] = case_scalar[int(contrib_case[c])]
    f = jnp.asarray
    idx_m = mm_W = mm_gather = mm_inv = None
    Km = ncase_m = 0
    mc = np.where(is_mm)[0]
    if len(mc):
        order = mc[np.lexsort((mc, contrib_case[mc]))]
        cs = contrib_case[order]
        cases_present = sorted(set(int(k) for k in cs))
        case_col = {k: j for j, k in enumerate(cases_present)}
        ncase_m = len(cases_present)
        m = case_T.shape[1]
        W = np.concatenate([case_T[k].T for k in cases_present], axis=1)
        mm_if = np.unique(contrib_iface[order])
        remap = np.full(num_ifaces, -1, dtype=np.int64)
        remap[mm_if] = np.arange(len(mm_if))
        by_mm = [[] for _ in range(len(mm_if))]
        for r, c in enumerate(order):
            # row r of the merged matmul output, case block of c
            by_mm[int(remap[contrib_iface[c]])].append(
                r * ncase_m + case_col[int(contrib_case[c])]
            )
        Km = max(len(v) for v in by_mm)
        pad_val = len(order) * ncase_m  # the appended zero-source row
        gath = np.full((len(mm_if), Km), pad_val, dtype=np.int32)
        for i, v in enumerate(by_mm):
            gath[i, : len(v)] = v
        inv = np.full(num_ifaces, len(mm_if), dtype=np.int32)
        inv[mm_if] = np.arange(len(mm_if))
        idx_m = f(np.concatenate([flat[order], [pad_row]]).astype(np.int32))
        mm_W = f(np.asarray(W, dtype=np.dtype(dtype)))
        mm_gather = f(gath.reshape(-1))
        mm_inv = f(inv)
    return _ContribPipeline(
        num_ifaces=num_ifaces,
        Ks=Ks,
        idx_s=f(idx_s.reshape(-1)),
        w_s=f(np.asarray(w_s, dtype=np.dtype(dtype))),
        idx_m=idx_m,
        mm_W=mm_W,
        mm_ncase=ncase_m,
        Km=Km,
        mm_gather=mm_gather,
        mm_inv=mm_inv,
    )


def _denom_of(st: _SolverTables, D: int, n: int) -> jnp.ndarray:
    """Materialize the ``[Ps, *ns]`` eigen-denominator from the factored
    per-axis rows (fused by XLA into the consuming divide; see the
    ``lam_tab`` field note).  Summed in f64, cast after — matching the
    old dense-table bit pattern exactly."""
    Ps = st.lam_idx.shape[0]
    rows = st.lam_tab[st.lam_idx.reshape(-1)].reshape(Ps, D, n)
    if D == 2:
        dn = rows[:, 1][:, :, None] + rows[:, 0][:, None, :]
    else:
        dn = (
            rows[:, 2][:, :, None, None]
            + rows[:, 1][:, None, :, None]
            + rows[:, 0][:, None, None, :]
        )
    if st.denom_dtype is not None:
        dn = dn.astype(st.denom_dtype)
    return dn


def _spectral_apply(st: _SolverTables, fc: jnp.ndarray, D: int, n: int) -> jnp.ndarray:
    """Batched spectral patch solves with the tables ``st`` (the jittable
    core of ``Level._spectral_solve``)."""
    P = fc.shape[0]
    cells = int(np.prod(fc.shape[1:]))
    denom_sorted = _denom_of(st, D, n)
    if st.kron is not None:
        # flat Kronecker path (f32): the BC-sort permutation, the
        # transforms, and the eigen-divide all act on [Ps, n^2(*n)] rows
        fflat = fc.reshape(P, cells)
        fs = fflat if st.identity_perm else fflat[st.perm]
        dnf = denom_sorted.reshape(P, -1) if D == 2 else (
            denom_sorted.reshape(P, n, cells // n)
        )
        parts = []
        for g, kr in zip(st.groups, st.kron):
            x = jax.lax.slice_in_dim(fs, g.start, g.stop, axis=0)
            dn = jax.lax.slice_in_dim(dnf, g.start, g.stop, axis=0)
            if D == 2:
                y = (x @ kr[0].astype(x.dtype)) / dn
                if g.pin_dc:
                    y = y.at[:, 0].set(0.0)
                y = y @ kr[1].astype(x.dtype)
            else:
                W1, W2, Tz1, Tz2 = kr
                x3 = x.reshape(x.shape[0], n, cells // n)
                y = jnp.einsum("pwl,zw->pzl", x3, Tz1.astype(x.dtype))
                y = (y @ W1.astype(x.dtype)) / dn
                if g.pin_dc:
                    y = y.at[:, 0, 0].set(0.0)
                y = jnp.einsum("pwl,zw->pzl", y, Tz2.astype(x.dtype))
                y = (y @ W2.astype(x.dtype)).reshape(x.shape[0], cells)
            parts.append(y)
        us = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        out = us if st.identity_perm else us[st.inv_perm]
        return out.reshape(fc.shape)
    if st.identity_perm:
        fs = fc
    else:  # flattened rank-2 row gather
        fs = fc.reshape(P, cells)[st.perm].reshape(fc.shape)
    parts = []
    scale = (2.0 / n) ** D
    for g in st.groups:
        x = jax.lax.slice_in_dim(fs, g.start, g.stop, axis=0)
        dn = jax.lax.slice_in_dim(denom_sorted, g.start, g.stop, axis=0)
        for a in range(D):
            x = Level._apply_transform(st.tmats[g.fwd_kinds[a]], x, _arr_axis(D, a))
        x = x / dn
        if g.pin_dc:
            zero_idx = (slice(None),) + (0,) * D
            x = x.at[zero_idx].set(0.0)
        for a in range(D):
            x = Level._apply_transform(st.tmats[g.inv_kinds[a]], x, _arr_axis(D, a))
        parts.append(x * scale)
    us = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
    if st.identity_perm:
        return us
    return us.reshape(P, cells)[st.inv_perm].reshape(fc.shape)


class Level:
    """Device tables + jitted core ops for one refinement level."""

    def __init__(self, patch_level: PatchLevel, dtype=jnp.float64,
                 patch_solver: str = "dft", iface_scheme: str = "bilinear"):
        self.patch_solver_kind = patch_solver  # "dft" (spectral) | "bcgs"
        self.iface_scheme = iface_scheme
        self.pl = patch_level
        self.D = patch_level.D
        self.n = patch_level.n
        self.P = patch_level.num_patches
        self.dtype = dtype
        self.m = self.n ** (self.D - 1)

        t = getattr(patch_level, "prebuilt_iface_tables", None)
        if t is None or iface_scheme != "bilinear":
            t = iface_mod.build_iface_tables(patch_level, scheme=iface_scheme)
        self.tables = t
        self.num_ifaces = t.num_ifaces
        self.face_depth = getattr(t, "face_depth", 1)

        npdt = np.dtype(dtype)
        f = lambda x: jnp.asarray(x)
        fc = lambda x: jnp.asarray(np.asarray(x, dtype=npdt))

        # gather-form of the interface reduction: per interface, the (padded)
        # list of contribution rows that accumulate into it — turns the
        # scatter-add in `interpolate` into a gather+sum.
        # --- contribution pipeline, case-sorted for matmul templates -------
        # Instead of per-element index arithmetic (take_along_axis), each
        # case's (weights, source-index) template becomes a dense m×m
        # matrix and contributions are sorted by case so each case is one
        # [R, m] @ [m, m] matmul.
        C = len(t.contrib_patch)
        ncase = t.case_w.shape[0]
        m = t.m
        case_T = np.zeros((ncase, m, m))
        for k in range(ncase):
            for i in range(m):
                for kk in range(t.case_w.shape[2]):
                    w = t.case_w[k, i, kk]
                    if w != 0.0:
                        case_T[k, i, t.case_src[k, i, kk]] += w
        self._case_T = fc(case_T)  # [ncase, m, m]
        # cases whose template is a scalar multiple of the identity
        # (normal = I/2, c2c = I/3 — the bulk of all contributions) are
        # applied as elementwise scalings: exact at any precision and far
        # cheaper than a matmul
        self._case_scalar = []
        for k in range(ncase):
            diag = np.diag(case_T[k])
            if np.allclose(case_T[k], np.diag(diag)) and np.allclose(diag, diag[0] if m else 0):
                self._case_scalar.append(float(diag[0]) if m else 0.0)
            else:
                self._case_scalar.append(None)

        self._pipe = _build_contrib_pipeline(
            t.contrib_patch, t.contrib_side, t.contrib_case, t.contrib_iface,
            t.num_ifaces, case_T, self._case_scalar, dtype,
            2 * self.D * self.face_depth, self.P,
        )
        # gamma -> per-patch-side faces: one flattened padded row gather
        # (masked sides route to the zero pad row)
        if_flat = np.asarray(t.iface_side_idx, dtype=np.int64).copy()
        if_flat[np.asarray(t.iface_side_mask) == 0] = t.num_ifaces
        self._iface_flat = f(if_flat.reshape(-1).astype(np.int32))

        # --- direct gf pipeline (apply/smooth fast path) -------------------
        # For a same-level interface the ghost closure collapses:
        # ghost = 2*gamma - u_b = 2*(u_b + u_nbr)/2 - u_b = u_nbr — the
        # classic halo.  So gf on "direct" sides is 0.5*own + 0.5*nbr (one
        # neighbor-face row gather), and only the refinement-boundary
        # interfaces need the full contribution pipeline (a compact one).
        # The Schur path keeps the full-gamma pipeline (`interpolate`).
        self._build_gf_tables(t, dtype)

        # stencil coefficients
        h2inv = (1.0 / patch_level.spacings**2).astype(np.float64)
        self.h2inv = fc(h2inv)  # [P, D]
        # ghost closure: ghost = c*u_b + 2*gamma; c=+1 Neumann, -1 otherwise
        # (StarPatchOp.h:39-65: interface/Dirichlet rows -3u_b, Neumann -1u_b)
        coef = np.where(patch_level.neumann, 1.0, -1.0)
        self.ghost_coef = fc(coef)  # [P, 2D]
        # apply fast path: own-face gf term folded into the ghost closure
        # (ghost = (c + 2*w_own)*u_b + 2*w_mix*mix; 0 on direct sides)
        # f32-step arithmetic (cast operands first, then add) to match
        # the pre-r5 on-device computation bit-for-bit
        self.ghost_coef_eff = f(
            np.asarray(coef, dtype=npdt)
            + np.asarray(2.0, dtype=npdt)
            * np.asarray(self._gf_w_own_np[:, :, 0], dtype=npdt)
        )

        self._st = _build_solver_tables(
            self.pl, self.dtype, np.arange(self.P, dtype=np.int64)
        )
        self._jit_cache = {}
        # multi-device: optional device mesh; when set, the core ops pin
        # their outputs to the patch-axis sharding so XLA partitions the
        # whole pipeline (gathers become collectives — the replacement of
        # the reference's VecScatters, SURVEY.md §5)
        self.set_mesh(None)

    def _build_gf_tables(self, t, dtype) -> None:
        """Tables of the direct gf pipeline (see __init__)."""
        D, P, m = self.D, self.P, self.m
        S2 = 2 * D
        S2f = S2 * self.face_depth
        NR = P * S2f  # face-row count; combined source = [faces | gamma_ref | 0]
        by_iface: dict = {}
        for c in range(len(t.contrib_patch)):
            by_iface.setdefault(int(t.contrib_iface[c]), []).append(c)
        isidx = np.asarray(t.iface_side_idx)
        ismask = np.asarray(t.iface_side_mask)
        readers: dict = {}
        for p in range(P):
            for s in range(S2):
                if ismask[p, s]:
                    readers.setdefault(int(isidx[p, s]), []).append((p, s))
        # direct = exactly two scalar-0.5 contributions, each being the
        # boundary face row of one of the interface's two reader sides
        direct = {}
        for i, lst in by_iface.items():
            if len(lst) != 2 or len(readers.get(i, ())) != 2:
                continue
            ok = all(
                self._case_scalar[int(t.contrib_case[c])] == 0.5
                and int(t.contrib_side[c]) % self.face_depth == 0
                for c in lst
            )
            crows = {
                int(t.contrib_patch[c]) * S2f + int(t.contrib_side[c])
                for c in lst
            }
            orows = {
                p * S2f + s * self.face_depth for p, s in readers[i]
            }
            if ok and crows == orows:
                direct[i] = lst
        ref_ids = np.array(
            sorted(i for i in by_iface if i not in direct), dtype=np.int64
        )
        ref_remap = np.full(max(t.num_ifaces, 1), -1, dtype=np.int64)
        ref_remap[ref_ids] = np.arange(len(ref_ids))
        self._nref = len(ref_ids)
        self._gf_ref_pipe = None
        if self._nref:
            keep = ref_remap[t.contrib_iface] >= 0
            case_T = np.asarray(self._case_T, dtype=np.float64)
            self._gf_ref_pipe = _build_contrib_pipeline(
                t.contrib_patch[keep], t.contrib_side[keep],
                t.contrib_case[keep], ref_remap[t.contrib_iface[keep]],
                self._nref, case_T, self._case_scalar, dtype, S2f, P,
            )
        mix_idx = np.full((P, S2), NR + self._nref, dtype=np.int64)  # pad->0 row
        w_own = np.zeros((P, S2, 1))
        w_mix = np.zeros((P, S2, 1))
        for p in range(P):
            for s in range(S2):
                if not ismask[p, s]:
                    continue
                i = int(isidx[p, s])
                if i in direct:
                    own_row = p * S2f + s * self.face_depth
                    rows = [
                        int(t.contrib_patch[c]) * S2f + int(t.contrib_side[c])
                        for c in direct[i]
                    ]
                    if own_row in rows:
                        rows.remove(own_row)
                        mix_idx[p, s] = rows[0]
                        w_own[p, s] = 0.5
                        w_mix[p, s] = 0.5
                        continue
                # refinement (or irregular) side: gf = full gamma of iface i
                mix_idx[p, s] = NR + ref_remap[i]
                w_mix[p, s] = 1.0
                if ref_remap[i] < 0:  # direct iface read by a third side
                    mix_idx[p, s] = NR + self._nref  # cannot happen; pad
        f = jnp.asarray
        npdt = np.dtype(dtype)
        self._gf_mix_idx = f(mix_idx.reshape(-1).astype(np.int32))
        self._gf_w_own_np = w_own  # host copy (ghost_coef_eff derives from it)
        self._gf_w_own = f(np.asarray(w_own, dtype=npdt))
        self._gf_w_mix = f(np.asarray(w_mix, dtype=npdt))

    def _gf_parts(self, u: jnp.ndarray):
        """``(w_mix * mix, own)`` of the direct gf pipeline, both
        ``[P, 2D, m]`` (direct sides: halo of neighbor faces; refinement
        sides: compact contribution pipeline)."""
        D, m, P = self.D, self.m, self.P
        S2 = 2 * D
        if self.num_ifaces == 0:
            z = jnp.zeros((P, S2, m), dtype=u.dtype)
            return z, z
        faces = extract_faces(u, D, self.n, self.face_depth)  # [P, S2f, m]
        ff = faces.reshape(-1, m)
        own = faces.reshape(P, S2, self.face_depth, m)[:, :, 0]  # [P, S2, m]
        if self._gf_ref_pipe is not None:
            gref = self._gf_ref_pipe.interpolate(faces, m)
        else:
            gref = jnp.zeros((0, m), dtype=u.dtype)
        combined = jnp.concatenate(
            [ff, gref, jnp.zeros((1, m), dtype=u.dtype)], axis=0
        )
        mix = combined[self._gf_mix_idx].reshape(P, S2, m)
        return self._gf_w_mix.astype(u.dtype) * mix, own

    def _gf_faces(self, u: jnp.ndarray) -> jnp.ndarray:
        """Per-patch-side interface traces ``[P, 2D, m]`` — the
        apply/smooth fast path."""
        mix_scaled, own = self._gf_parts(u)
        return self._gf_w_own.astype(u.dtype) * own + mix_scaled

    # -- sharding ------------------------------------------------------------

    def set_mesh(self, mesh) -> None:
        """Shard this level's ops over ``mesh`` (1D, axis ``"p"``): patch
        arrays on the leading patch axis, interface vectors on the leading
        interface axis."""
        from jax.sharding import NamedSharding, PartitionSpec

        self.mesh = mesh
        # the fused stencil kernel (ops/stencil_gpu.py) runs on one GPU
        self.fused_stencil = mesh is None and jax.default_backend() == "gpu"
        if mesh is None:
            self._psh = self._gsh = None
            return
        self._psh = NamedSharding(mesh, PartitionSpec("p"))
        self._gsh = NamedSharding(mesh, PartitionSpec("p"))

    def _constrain_p(self, x: jnp.ndarray) -> jnp.ndarray:
        if self._psh is None:
            return x
        return jax.lax.with_sharding_constraint(x, self._psh)

    def _constrain_g(self, g: jnp.ndarray) -> jnp.ndarray:
        if self._gsh is None or g.shape[0] == 0:
            return g
        return jax.lax.with_sharding_constraint(g, self._gsh)

    # solver-table views (the halo engine re-blocks these per shard)
    @property
    def _solve_groups(self):
        return self._st.groups

    @property
    def _tmats(self):
        return self._st.tmats

    @property
    def _denom_sorted(self):
        # dense [Ps, *ns] view for consumers that re-block it per shard at
        # SETUP time (halo engine); the jitted ops use the factored form
        return _denom_of(self._st, self.D, self.n)

    @property
    def _solver_inv_perm(self):
        return self._st.inv_perm

    # -- core linear maps ---------------------------------------------------

    def interpolate(self, u: jnp.ndarray) -> jnp.ndarray:
        """Trace interpolation: ``gamma[NIf, m]`` from patch values."""
        if self.num_ifaces == 0:  # single isolated patch (coarsest level)
            return jnp.zeros((0, self.m), dtype=u.dtype)
        faces = extract_faces(u, self.D, self.n, self.face_depth)  # [P, 2D*depth, m]
        return self._constrain_g(self._pipe.interpolate(faces, self.m))

    def gamma_faces(self, gamma: jnp.ndarray) -> jnp.ndarray:
        """Per-patch-side interface traces ``[P, 2D, m]`` (zero where no nbr).

        One flattened padded row gather: masked sides index the appended
        zero row, so no mask multiply is needed."""
        if self.num_ifaces == 0:
            return jnp.zeros((self.P, 2 * self.D, self.m), dtype=gamma.dtype)
        gp = jnp.concatenate(
            [gamma, jnp.zeros((1, self.m), dtype=gamma.dtype)], axis=0
        )
        return gp[self._iface_flat].reshape(self.P, 2 * self.D, self.m)

    def apply_with_interface(self, u: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """Stencil apply with explicit interface values
        (``StarPatchOp::applyWithInterface``, ``StarPatchOp.h:28-184``)."""
        return self._stencil_with_faces(u, self.gamma_faces(gamma))

    def _stencil_with_faces(self, u: jnp.ndarray, gf: jnp.ndarray) -> jnp.ndarray:
        return self._constrain_p(
            _stencil(u, gf, self.ghost_coef, self.h2inv, self.D, self.n,
                     self.fused_stencil)
        )

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """Composite-grid operator ``A u`` (``SchurHelper.h:360-376``),
        via the direct gf pipeline (same values as
        ``apply_with_interface(u, interpolate(u))``).

        Fast path: ``ghost = c*u_b + 2*(w_own*u_b + w_mix*mix)`` — the
        own-face term is folded into an effective ghost coefficient
        (``c + 2*w_own``; exactly 0 on direct sides, where the ghost is
        the plain neighbor-face halo), so the stencil consumes the mixed
        term directly and the own-face combine pass disappears."""
        mix_scaled, _ = self._gf_parts(u)
        return self._constrain_p(
            _stencil(u, mix_scaled, self.ghost_coef_eff, self.h2inv,
                     self.D, self.n, self.fused_stencil)
        )

    def _fold_gamma_into_rhs(self, fc: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """``f_slice -= 2/h^2 * gamma`` on every neighbored side
        (``StarPatchOp::addInterfaceToRHS``, ``StarPatchOp.h:185-203``)."""
        return self._fold_faces_into_rhs(fc, self.gamma_faces(gamma))

    def fold_gamma(self, fc: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """Public ghost injection ``f - G gamma`` (see the sharded
        counterpart ``ShardedLevel.fold_gamma``)."""
        return self._fold_gamma_into_rhs(fc, gamma)

    def _fold_faces_into_rhs(self, fc: jnp.ndarray, gf: jnp.ndarray) -> jnp.ndarray:
        return _fold_faces_flat(fc, gf, self.h2inv, self.D, self.n)

    @staticmethod
    def _apply_transform(M: jnp.ndarray, x: jnp.ndarray, ax: int) -> jnp.ndarray:
        """Apply n×n transform along array axis ``ax`` as one big matmul,
        at the backend's default precision (f32 operands: TF32 on the GPU;
        f64 operands: exact f64)."""
        n = M.shape[0]
        moved = jnp.moveaxis(x, ax, -1)
        shape = moved.shape
        y = jnp.matmul(moved.reshape(-1, n), M.T)
        return jnp.moveaxis(y.reshape(shape), -1, ax)

    def patch_solve_faces(self, f: jnp.ndarray, gf: jnp.ndarray) -> jnp.ndarray:
        """Patch solves with explicit per-patch-side trace values
        ``gf[P, 2D, m]`` (used by Schur probing)."""
        return self._spectral_solve(self._fold_faces_into_rhs(f, gf))

    def patch_solve(self, f: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """Exact per-patch solves: spectral diagonalization by default
        (``FftwPatchSolver.h:173-206``), or batched per-patch BiCGStab when
        constructed with ``patch_solver="bcgs"`` (the reference
        ``BiCGStabSolver`` fallback)."""
        fc = self._fold_gamma_into_rhs(f, gamma)
        if self.patch_solver_kind == "bcgs":
            from .patch_bcgs import batched_patch_bicgstab

            zero_g = jnp.zeros((self.num_ifaces, self.m), dtype=f.dtype)
            return batched_patch_bicgstab(
                lambda u: self.apply_with_interface(u, zero_g), fc,
                tol=1e-12, max_iter=500,
            )
        return self._spectral_solve(fc)

    def _spectral_solve(self, fc: jnp.ndarray) -> jnp.ndarray:
        return self._constrain_p(_spectral_apply(self._st, fc, self.D, self.n))

    def smooth(self, f: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """One FFT block-Jacobi sweep (``SchurHelper::solveWithSolution``),
        via the direct gf pipeline."""
        if self.patch_solver_kind == "bcgs":
            return self.patch_solve(f, self.interpolate(u))
        fc = _fold_faces_flat(f, self._gf_faces(u), self.h2inv, self.D, self.n)
        return self._spectral_solve(fc)

    def smooth_zero(self, f: jnp.ndarray) -> jnp.ndarray:
        """``smooth(f, 0)``: with a zero iterate the interface traces are
        identically zero, so the whole interpolate/gather/RHS-fold pipeline
        drops out — just the batched spectral solve.  Used for the first
        pre-smooth of every GMG level visit (latency-bound at deep levels)."""
        if self.patch_solver_kind == "bcgs":
            zero_g = jnp.zeros((self.num_ifaces, self.m), dtype=f.dtype)
            return self.patch_solve(f, zero_g)
        return self._spectral_solve(f)

    def solve_with_interface(self, f: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """Patch solves with explicit interface values (Schur path)."""
        return self.patch_solve(f, gamma)

    def gamma_zeros(self, dtype=None) -> jnp.ndarray:
        """Zero interface vector in this engine's gamma layout."""
        return self._constrain_g(
            jnp.zeros((self.num_ifaces, self.m), dtype=dtype or self.dtype)
        )

    def schur_S(self, gamma: jnp.ndarray) -> jnp.ndarray:
        """Matrix-free Schur operator ``S gamma = interp(patch_solve(0, g))``
        (``SchurWrapOp.h:47-53``)."""
        zf = jnp.zeros((self.P,) + self.pl.ns_shape, dtype=gamma.dtype)
        return self.interpolate(self.patch_solve(zf, gamma))

    # -- reductions ---------------------------------------------------------

    def integrate(self, u: jnp.ndarray) -> jnp.ndarray:
        """Volume integral (``Domain.h:258-278``)."""
        cellvol = jnp.prod(jnp.asarray(self.pl.spacings), axis=1)
        sums = jnp.sum(u.reshape(self.P, -1), axis=1)
        return jnp.sum(sums * cellvol)

    @property
    def volume(self) -> float:
        return self.pl.volume()

    def zeros(self) -> jnp.ndarray:
        return jnp.zeros((self.P,) + self.pl.ns_shape, dtype=self.dtype)


class ActiveSmoother:
    """FAC active-set block-Jacobi smoother, subset-compute form.

    One sweep replaces the iterate on a static subset of patches with their
    exact patch solves (traces interpolated from the full current iterate);
    every other patch is left untouched.  Only the interfaces adjacent to
    active patches are interpolated and only active patches are solved, so
    a sweep costs O(active) instead of O(level).

    This is the classical-FAC relaxation (each level relaxes only the
    region it is the finest representation of); the reference instead
    relaxes every patch of every level
    (``GMG/FFTBlockJacobiSmoother.h:31-59``) — on its pass-through-heavy
    FAC hierarchies ~90-95% of that work re-relaxes patches that are
    bit-identical on the finer level.  Iteration counts are unchanged.
    """

    def __init__(self, level: Level, active: np.ndarray, build_solver: bool = True):
        self.level = level
        D, n, m = level.D, level.n, level.m
        self.D, self.n, self.m = D, n, m
        P = level.P
        act = np.where(np.asarray(active))[0]
        self.act = act
        self.Pa = len(act)
        f = jnp.asarray
        self._act = f(act)
        self._mask = f(np.asarray(active).reshape((P,) + (1,) * D))
        inv = np.full(P, self.Pa, dtype=np.int32)  # pad row = untouched
        inv[act] = np.arange(self.Pa, dtype=np.int32)
        self._inv = f(inv)

        t = level.tables
        # interfaces the active patches read: remap to a compact range
        ii = np.asarray(t.iface_side_idx)[act]  # [Pa, 2D]
        mm = np.asarray(t.iface_side_mask)[act] > 0
        needed = np.unique(ii[mm]) if mm.any() else np.zeros(0, dtype=np.int64)
        self.num_sub_ifaces = len(needed)
        remap = np.full(max(t.num_ifaces, 1), -1, dtype=np.int64)
        remap[needed] = np.arange(len(needed))

        # reduced contribution pipeline: only contributions that land on a
        # needed interface, sourcing faces from just the contributing
        # patches (active + their face neighbors)
        keep = remap[t.contrib_iface] >= 0
        cp = t.contrib_patch[keep]
        src = np.unique(cp) if len(cp) else np.zeros(0, dtype=np.int64)
        src_remap = np.full(P, -1, dtype=np.int64)
        src_remap[src] = np.arange(len(src))
        self._src = f(src)
        case_T = np.asarray(level._case_T, dtype=np.float64)
        self._pipe = _build_contrib_pipeline(
            src_remap[cp],
            t.contrib_side[keep],
            t.contrib_case[keep],
            remap[t.contrib_iface[keep]],
            self.num_sub_ifaces,
            case_T,
            level._case_scalar,
            level.dtype,
            2 * D * level.face_depth,
            len(src),
        )
        # flattened per-(active patch, side) gamma routing (masked -> pad)
        gidx = np.asarray(remap[ii], dtype=np.int64).copy()
        gidx[~mm] = self.num_sub_ifaces
        self._g_flat = f(gidx.reshape(-1).astype(np.int32))

        self._st = (
            _build_solver_tables(level.pl, level.dtype, act) if build_solver else None
        )
        self._h2inv_act = f(np.asarray(level.h2inv)[act])
        self._ghost_act = f(np.asarray(level.ghost_coef)[act])

    def _row_gather(self, x: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
        """Leading-axis gather via the flattened rank-2 view."""
        P = x.shape[0]
        return x.reshape(P, -1)[idx].reshape((len(idx),) + x.shape[1:])

    def _gamma_faces(self, u: jnp.ndarray) -> jnp.ndarray:
        """[Pa, 2D, m] interface traces at the active patches' faces,
        interpolated from the full iterate via the reduced pipeline."""
        lvl = self.level
        faces = extract_faces(
            self._row_gather(u, self._src), self.D, self.n, lvl.face_depth
        )
        gamma = self._pipe.interpolate(faces, self.m)  # [NIsub, m]
        gp = jnp.concatenate(
            [gamma, jnp.zeros((1, self.m), dtype=gamma.dtype)], axis=0
        )
        return gp[self._g_flat].reshape(self.Pa, 2 * self.D, self.m)

    def _fold(self, fc: jnp.ndarray, gf: jnp.ndarray) -> jnp.ndarray:
        """``f -= 2/h^2 gamma`` on active patches' neighbored faces
        (``StarPatchOp::addInterfaceToRHS``)."""
        return _fold_faces_flat(fc, gf, self._h2inv_act, self.D, self.n)

    def _scatter(self, sol: jnp.ndarray, base: jnp.ndarray) -> jnp.ndarray:
        """Route the active solves back to their level slots (row gather —
        no device scatter), leaving ``base`` elsewhere."""
        pad = jnp.zeros((1,) + sol.shape[1:], dtype=sol.dtype)
        sol_pad = jnp.concatenate([sol, pad], axis=0)
        routed = self._row_gather(sol_pad, self._inv)
        return jnp.where(self._mask, routed, base)

    def smooth(self, f: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        fa = self._row_gather(f, self._act)
        if self.num_sub_ifaces:
            fa = self._fold(fa, self._gamma_faces(u))
        sol = _spectral_apply(self._st, fa, self.D, self.n)
        return self._scatter(sol, u)

    def smooth_zero(self, f: jnp.ndarray) -> jnp.ndarray:
        """``smooth(f, 0)`` — traces vanish, so just the subset solves."""
        sol = _spectral_apply(self._st, self._row_gather(f, self._act), self.D, self.n)
        return self._scatter(sol, jnp.zeros((), dtype=f.dtype))

    def apply_scattered(self, u: jnp.ndarray) -> jnp.ndarray:
        """``A u`` scattered into a zero field, computed on the subset only.

        Exact for the full composite operator whenever ``u`` vanishes
        outside a set A with nbr(A) ⊆ this subset: every nonzero row of
        ``A u`` is then in the subset.  Used for the FAC coarse-level
        residual ``r = f − A u`` after active-set pre-smoothing, where
        ``u`` is nonzero only on the active patches."""
        gf = (
            self._gamma_faces(u)
            if self.num_sub_ifaces
            else jnp.zeros((self.Pa, 2 * self.D, self.m), dtype=u.dtype)
        )
        out = _stencil(
            self._row_gather(u, self._act),
            gf,
            self._ghost_act.astype(u.dtype),
            self._h2inv_act.astype(u.dtype),
            self.D,
            self.n,
            self.level.fused_stencil,
        )
        return self._scatter(out, jnp.zeros((), dtype=u.dtype))
