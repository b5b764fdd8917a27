"""Explicit matrix assembly for the composite operator.

Replacement of the reference's L6 matrix layer
(``MatrixHelper``/``MatrixHelper2d``/``SchurMatrixHelper*`` — SURVEY.md
§2.6): instead of hand-written boundary-closure stencil tables, the global
CSR matrix is composed algebraically from the same host tables the
matrix-free path uses,

    ``A = L_patch + G @ Gamma``

where ``L_patch`` is the block-diagonal patch stencil (with the per-side
boundary coefficients), ``Gamma`` the trace-interpolation matrix
(u -> interface values) and ``G`` the ghost-closure injection
(``+2 gamma / h^2`` into boundary rows).  By construction the assembled
matrix is *exactly* the matrix-free operator — the invariant the tests
check with random vectors.

The assembled matrix serves: direct sparse solves for validation, the
``crs`` matrix-type option, and AMG-style external solvers.  A BCOO
wrapper provides a jittable device SpMV.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from .domain import PatchLevel
from .iface import IfaceTables, build_iface_tables


def _face_cell_flat(D: int, n: int, s: int, depth: int = 0) -> np.ndarray:
    """Flat in-patch cell index of each face-vector entry of side ``s``,
    ``depth`` cells inward from the boundary.

    Face vector order: lowest remaining axis fastest; patch flat order:
    C order of [z, y, x] (x fastest)."""
    a = s // 2
    fixed = depth if s % 2 == 0 else n - 1 - depth
    m = n ** (D - 1)
    idx = np.arange(m)
    coords = np.zeros((m, D), dtype=np.int64)  # coords[:, axis]
    rem = [ax for ax in range(D) if ax != a]
    for k, ax in enumerate(rem):
        coords[:, ax] = (idx // (n**k)) % n
    coords[:, a] = fixed
    flat = np.zeros(m, dtype=np.int64)
    for ax in range(D):
        flat += coords[:, ax] * (n**ax)
    return flat


def assemble_interpolation(level: PatchLevel, tables: IfaceTables = None) -> sp.csr_matrix:
    """``Gamma``: (num_ifaces*m) x (P*n^D) trace-interpolation matrix."""
    t = tables or build_iface_tables(level)
    D, n = level.D, level.n
    m = t.m
    cells = n**D
    depth = getattr(t, "face_depth", 1)
    rows, cols, vals = [], [], []
    for c in range(len(t.contrib_patch)):
        p = int(t.contrib_patch[c])
        code = int(t.contrib_side[c])
        s, d = (code // depth, code % depth) if depth > 1 else (code, 0)
        i = int(t.contrib_iface[c])
        k = int(t.contrib_case[c])
        W = t.case_w[k]  # [m, K]
        S = t.case_src[k]
        face_flat = _face_cell_flat(D, n, s, d)
        for out_i in range(m):
            for kk in range(W.shape[1]):
                w = W[out_i, kk]
                if w != 0.0:
                    rows.append(i * m + out_i)
                    cols.append(p * cells + face_flat[S[out_i, kk]])
                    vals.append(w)
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(t.num_ifaces * m, level.num_patches * cells)
    )


def assemble_patch_stencil(level: PatchLevel) -> sp.csr_matrix:
    """Block-diagonal patch Laplacian with boundary-closure coefficients
    (the homogeneous part of ``StarPatchOp::applyWithInterface``)."""
    D, n = level.D, level.n
    P = level.num_patches
    cells = n**D
    rows, cols, vals = [], [], []
    coords = np.zeros((cells, D), dtype=np.int64)
    idx = np.arange(cells)
    for ax in range(D):
        coords[:, ax] = (idx // (n**ax)) % n
    for p in range(P):
        base = p * cells
        for a in range(D):
            h2inv = 1.0 / level.spacings[p, a] ** 2
            x = coords[:, a]
            # diagonal
            neum_lo = level.neumann[p, 2 * a]
            neum_hi = level.neumann[p, 2 * a + 1]
            c_lo = -1.0 if neum_lo else -3.0
            c_hi = -1.0 if neum_hi else -3.0
            diag = np.where(x == 0, c_lo, np.where(x == n - 1, c_hi, -2.0))
            rows.extend(base + idx)
            cols.extend(base + idx)
            vals.extend(diag * h2inv)
            # off-diagonals along axis a
            sel = x < n - 1
            rows.extend(base + idx[sel])
            cols.extend(base + idx[sel] + n**a)
            vals.extend(np.full(sel.sum(), h2inv))
            rows.extend(base + idx[sel] + n**a)
            cols.extend(base + idx[sel])
            vals.extend(np.full(sel.sum(), h2inv))
    return sp.csr_matrix((vals, (rows, cols)), shape=(P * cells, P * cells))


def assemble_ghost_injection(level: PatchLevel, tables: IfaceTables = None) -> sp.csr_matrix:
    """``G``: (P*n^D) x (num_ifaces*m) injection of ``2 gamma / h^2`` into
    boundary rows of neighbored sides."""
    t = tables or build_iface_tables(level)
    D, n = level.D, level.n
    m = t.m
    cells = n**D
    rows, cols, vals = [], [], []
    for p in range(level.num_patches):
        for s in range(2 * D):
            if not t.iface_side_mask[p, s]:
                continue
            i = int(t.iface_side_idx[p, s])
            a = s // 2
            h2inv = 1.0 / level.spacings[p, a] ** 2
            face_flat = _face_cell_flat(D, n, s)
            rows.extend(p * cells + face_flat)
            cols.extend(i * m + np.arange(m))
            vals.extend(np.full(m, 2.0 * h2inv))
    return sp.csr_matrix(
        (vals, (rows, cols)), shape=(level.num_patches * cells, t.num_ifaces * m)
    )


def assemble_composite(level: PatchLevel, scheme: str = "bilinear") -> sp.csr_matrix:
    """The full composite-grid operator as CSR: ``A = L + G @ Gamma``.

    ``scheme="quadratic"`` assembles the 2D higher-order refinement
    closures (reference ``MatrixHelper2d.cpp:30-122``)."""
    t = build_iface_tables(level, scheme=scheme)
    L = assemble_patch_stencil(level)
    G = assemble_ghost_injection(level, t)
    Gamma = assemble_interpolation(level, t)
    return (L + G @ Gamma).tocsr()


def _dense_case_templates(tables: IfaceTables) -> np.ndarray:
    """Each interpolation case's (weights, source) template as a dense
    ``m×m`` matrix ``T`` with ``out = T @ face`` (same construction as
    ``ops.level_ops.Level``, kept in float64 here)."""
    ncase, m, K = tables.case_w.shape
    T = np.zeros((ncase, m, m))
    for k in range(ncase):
        for i in range(m):
            for kk in range(K):
                w = tables.case_w[k, i, kk]
                if w != 0.0:
                    T[k, i, tables.case_src[k, i, kk]] += w
    return T


def assemble_schur(level) -> sp.csr_matrix:
    """The explicit Schur interface matrix ``A_S = I - S`` by probing.

    Analog of the reference's probed Schur assembly with
    orientation canonicalization (``SchurMatrixHelper.cpp:24-205``,
    ``SchurMatrixHelper2d.cpp:130-190``): a patch's response to a unit
    interface trace depends only on its (Neumann bits, spacings) class, so
    interfaces are deduplicated into those classes (the batched form of the
    reference's rotation/flip ``Block`` algebra), *all* ``2D·m`` unit-trace
    probes of every class run in a single jitted ``lax.map`` of batched
    spectral solves (no per-probe host round-trips), and the m×m response
    blocks are placed under the interpolation-case templates on the host.

    ``level`` is an ``ops.level_ops.Level``.
    """
    import jax
    import jax.numpy as jnp

    from .domain import PatchLevel
    from .ops.level_ops import Level, extract_faces

    D, n = level.D, level.n
    t = level.tables
    m = t.m
    S2 = 2 * D
    NIf = t.num_ifaces
    P = level.P
    pl = level.pl

    # -- canonical patch classes ------------------------------------------
    uniq: dict = {}
    class_of = np.zeros(P, dtype=np.int64)
    reps: list = []
    for p in range(P):
        key = (
            tuple(bool(x) for x in pl.neumann[p]),
            tuple(float(x) for x in pl.spacings[p]),
        )
        if key not in uniq:
            uniq[key] = len(reps)
            reps.append(p)
        class_of[p] = uniq[key]
    U = len(reps)
    reps = np.asarray(reps)

    # -- one-representative-per-class mini level ---------------------------
    none_i8 = np.zeros((U, S2), dtype=np.int8)
    rep_pl = PatchLevel(
        D=D,
        n=n,
        tree_level=pl.tree_level,
        ids=np.arange(U, dtype=np.int64),
        starts=pl.starts[reps],
        spacings=pl.spacings[reps],
        refine_level=pl.refine_level[reps],
        parent_id=np.arange(U, dtype=np.int64),
        orth_on_parent=np.full(U, -1, dtype=np.int32),
        neumann=pl.neumann[reps],
        nbr_type=none_i8,
        nbr_slot=np.full((U, S2), -1, dtype=np.int64),
        coarse_orth=np.full((U, S2), -1, dtype=np.int32),
        fine_nbr_slots=np.full((U, S2, 1 << (D - 1)), -1, dtype=np.int64),
    )
    lvl_u = Level(rep_pl, dtype=level.dtype)

    # -- all 2D·m probes in one jitted sequential map ----------------------
    # responses are extracted to the tables' face depth (the quadratic
    # closures source the first-interior face too, and their contribution
    # codes are ``side*depth + d`` — iface.py:371-374)
    fd = level.face_depth
    B = S2 * m
    gf_all = np.zeros((B, U, S2, m))
    for s in range(S2):
        for j in range(m):
            gf_all[s * m + j, :, s, j] = 1.0
    zeros_u = jnp.zeros((U,) + rep_pl.ns_shape, dtype=level.dtype)

    @jax.jit
    def probe_all(gf_b):
        def one(gf):
            u = lvl_u.patch_solve_faces(zeros_u, gf)
            return extract_faces(u, D, n, fd)

        return jax.lax.map(one, gf_b)

    R = np.asarray(probe_all(jnp.asarray(gf_all, dtype=level.dtype)))
    # [src side, probe j, class, out face code (side*depth + d), m]
    R = R.reshape(S2, m, U, S2 * fd, m)

    # -- host placement under the case templates ---------------------------
    T = _dense_case_templates(t)  # [ncase, m, m]
    rows, cols, vals = [], [], []
    blk_r = np.repeat(np.arange(m), m)
    blk_c = np.tile(np.arange(m), m)
    for s in range(S2):
        src_iface = t.iface_side_idx[:, s]  # [P]
        src_mask = t.iface_side_mask[:, s]
        sel = np.where(src_mask[t.contrib_patch])[0]
        for c in sel:
            p = int(t.contrib_patch[c])
            sc = int(t.contrib_side[c])
            k = int(t.contrib_case[c])
            resp = R[s, :, class_of[p], sc, :]  # [probe j, m]
            block = T[k] @ resp.T  # [m out, m probe]
            rows.append(int(t.contrib_iface[c]) * m + blk_r)
            cols.append(int(src_iface[p]) * m + blk_c)
            vals.append(block.ravel())
    S_mat = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(NIf * m, NIf * m),
    )
    return (sp.identity(NIf * m, format="csr") - S_mat).tocsr()


def schur_block_jacobi(level, A_S: sp.csr_matrix = None, engine=None):
    """Block-Jacobi preconditioner for the interface system: inverts the
    m×m diagonal blocks of ``I - S`` (the reference's ``PBMatrix``
    ``getDiagInv`` + ``BlockJacobiSmoother``,
    ``Experimental/PBMatrix.cpp``).

    ``engine`` (optional): a halo ``ShardedLevel`` — the inverse blocks are
    then laid out in its owner-sharded gamma layout."""
    import jax.numpy as jnp

    if A_S is None:
        A_S = assemble_schur(level)
    m = level.m
    NIf = level.num_ifaces
    blocks = np.zeros((NIf, m, m))
    Acoo = A_S.tocoo()
    ri, ci, v = Acoo.row, Acoo.col, Acoo.data
    same = (ri // m) == (ci // m)
    for r, c, x in zip(ri[same], ci[same], v[same]):
        blocks[r // m, r % m, c % m] += x
    binv = np.linalg.inv(blocks)
    if engine is not None and hasattr(engine, "_owned_ids"):
        NOg = max(engine.NOg, 1)
        arr = np.tile(np.eye(m), (engine.ndev * NOg, 1, 1))
        for r, ids in enumerate(engine._owned_ids):
            for k, i in enumerate(ids):
                arr[r * NOg + k] = binv[i]
        binv = arr
    binv_j = jnp.asarray(binv, dtype=level.dtype)

    def M(gamma):
        return jnp.einsum("bij,bj->bi", binv_j, gamma)

    return M


def bcoo_matvec(csr: sp.csr_matrix):
    """Wrap a host CSR as a jittable device SpMV (BCOO)."""
    import jax.numpy as jnp
    from jax.experimental import sparse as jsparse

    coo = csr.tocoo()
    mat = jsparse.BCOO(
        (jnp.asarray(coo.data), jnp.asarray(np.stack([coo.row, coo.col], axis=1))),
        shape=coo.shape,
    )

    def mv(x):
        shape = x.shape
        return (mat @ x.ravel()).reshape(shape)

    return mv


def pbm_matvec(level):
    """Matrix-free "pointer-block" interface operator (the reference's
    experimental ``PBMatrix``, ``Experimental/PBMatrix.{h,cpp}``): the
    probed Schur matrix kept as deduplicated m×m coefficient blocks plus
    (row, col, block-id) pointers instead of CRS.

    Batched apply: entries are sorted by block id so each distinct
    block is ONE ``[E_c, m] @ [m, m]`` matmul over the gathered
    column traces, and the row reduction is the same iface-major padded
    gather-sum the interpolation pipeline uses (no scatter-adds).  Blocks
    are deduplicated by (probe side, patch class, source side, case) —
    the analog of the reference's rotation/flip canonicalization
    (``SchurMatrixHelper.cpp:24-205``).

    Returns a jittable ``gamma [NIf, m] -> (I - S) gamma``.
    """
    import jax.numpy as jnp

    from .ops.level_ops import Level, extract_faces

    D, n = level.D, level.n
    t = level.tables
    m = t.m
    S2 = 2 * D
    NIf = t.num_ifaces
    P = level.P

    # reuse assemble_schur's probing, but keep blocks deduplicated
    # (identical probe responses per class) instead of expanding to CSR
    import jax

    from .domain import PatchLevel

    pl = level.pl
    uniq: dict = {}
    class_of = np.zeros(P, dtype=np.int64)
    reps: list = []
    for p in range(P):
        key = (
            tuple(bool(x) for x in pl.neumann[p]),
            tuple(float(x) for x in pl.spacings[p]),
        )
        if key not in uniq:
            uniq[key] = len(reps)
            reps.append(p)
        class_of[p] = uniq[key]
    U = len(reps)
    reps_a = np.asarray(reps)
    none_i8 = np.zeros((U, S2), dtype=np.int8)
    rep_pl = PatchLevel(
        D=D, n=n, tree_level=pl.tree_level,
        ids=np.arange(U, dtype=np.int64),
        starts=pl.starts[reps_a], spacings=pl.spacings[reps_a],
        refine_level=pl.refine_level[reps_a],
        parent_id=np.arange(U, dtype=np.int64),
        orth_on_parent=np.full(U, -1, dtype=np.int32),
        neumann=pl.neumann[reps_a], nbr_type=none_i8,
        nbr_slot=np.full((U, S2), -1, dtype=np.int64),
        coarse_orth=np.full((U, S2), -1, dtype=np.int32),
        fine_nbr_slots=np.full((U, S2, 1 << (D - 1)), -1, dtype=np.int64),
    )
    lvl_u = Level(rep_pl, dtype=level.dtype)
    fd = level.face_depth
    gf_all = np.zeros((S2 * m, U, S2, m))
    for s in range(S2):
        for j in range(m):
            gf_all[s * m + j, :, s, j] = 1.0
    zeros_u = jnp.zeros((U,) + rep_pl.ns_shape, dtype=level.dtype)

    @jax.jit
    def probe_all(gf_b):
        def one(gf):
            u = lvl_u.patch_solve_faces(zeros_u, gf)
            return extract_faces(u, D, n, fd)

        return jax.lax.map(one, gf_b)

    R = np.asarray(probe_all(jnp.asarray(gf_all, dtype=level.dtype)))
    R = R.reshape(S2, m, U, S2 * fd, m)
    T = _dense_case_templates(t)  # [ncase, m, m]

    # -- pointer entries with deduplicated blocks --------------------------
    blk_ids: dict = {}
    blocks: list = []
    ent_row, ent_col, ent_blk = [], [], []
    for s in range(S2):
        src_iface = t.iface_side_idx[:, s]
        src_mask = t.iface_side_mask[:, s]
        sel = np.where(src_mask[t.contrib_patch])[0]
        for c in sel:
            p = int(t.contrib_patch[c])
            key = (s, int(class_of[p]), int(t.contrib_side[c]),
                   int(t.contrib_case[c]))
            b = blk_ids.get(key)
            if b is None:
                b = blk_ids[key] = len(blocks)
                # out = block @ gamma_col; store transposed for row @ W
                blocks.append(
                    (T[key[3]] @ R[s, :, key[1], key[2], :].T).T
                )
            ent_row.append(int(t.contrib_iface[c]))
            ent_col.append(int(src_iface[p]))
            ent_blk.append(b)
    E = len(ent_row)
    ent_row = np.asarray(ent_row, dtype=np.int64)
    ent_col = np.asarray(ent_col, dtype=np.int64)
    ent_blk = np.asarray(ent_blk, dtype=np.int64)
    W = np.stack(blocks) if blocks else np.zeros((1, m, m))

    # sort entries by block id -> per-block contiguous segments
    order = np.argsort(ent_blk, kind="stable")
    ent_row, ent_col, ent_blk = ent_row[order], ent_col[order], ent_blk[order]
    segs = []  # (block id, start, stop)
    start = 0
    while start < E:
        stop = start
        while stop < E and ent_blk[stop] == ent_blk[start]:
            stop += 1
        segs.append((int(ent_blk[start]), start, stop))
        start = stop

    # iface-major padded row reduction (gather+sum, no scatter)
    by_row: dict = {}
    for e in range(E):
        by_row.setdefault(int(ent_row[e]), []).append(e)
    Ks = max((len(v) for v in by_row.values()), default=1)
    gath = np.full((NIf, Ks), E, dtype=np.int64)  # pad -> zero row
    for i, lst in by_row.items():
        gath[i, : len(lst)] = lst

    cols_j = jnp.asarray(ent_col.astype(np.int32))
    gath_j = jnp.asarray(gath.reshape(-1).astype(np.int32))
    W_j = jnp.asarray(W, dtype=level.dtype)

    def mv(gamma):
        g_in = gamma[cols_j]  # [E, m] row gather
        parts = [
            jax.lax.slice_in_dim(g_in, a, b, axis=0) @ W_j[bid]
            for bid, a, b in segs
        ]
        y = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        ypad = jnp.concatenate(
            [y, jnp.zeros((1, m), dtype=y.dtype)], axis=0
        )
        acc = jnp.sum(
            ypad[gath_j].reshape(NIf, Ks, m), axis=1
        )
        return gamma - acc

    return mv
