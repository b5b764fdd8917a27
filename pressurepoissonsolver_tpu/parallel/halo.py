"""Cut-face halo exchange: explicitly scheduled sharded level ops.

The pjit path (``ops/level_ops.Level`` + ``with_sharding_constraint``) lets
XLA partition the global gathers; this module is the hand-scheduled
communication-optimal alternative — the equivalent of the
reference's recurring data motion (PETSc ``VecScatter``s for the interface
vector, ``SchurHelper.h:130-150``, and the GMG interlevel scatters,
``GMG/InterLevelComm.h:150-189``):

* Every patch reads only *its own* side interfaces; the cross-shard
  coupling is that a remote patch's **face trace** contributes to a local
  interface.  So the only data that moves is the set of cut faces —
  face rows of patches whose interface readers live on another shard.
* At setup, the cut faces are grouped by **shard offset** ``d``: shard
  ``q`` sends the same-shaped batch of face rows to shard ``(q+d) % n``
  for every ``d`` that occurs (with a Morton block partition nearly all
  traffic is ``d = ±1``).  Each offset is one ``jax.lax.ppermute`` (point
  to point, no all-gather; on GPUs a NCCL send/receive over NVLink).
* Each shard then computes its needed interface values *locally* (both
  owners of a cut interface recompute it — recompute-over-communicate:
  one hop instead of the reference's scatter-add + scatter-back) and runs
  the ghost-closure stencil / patch-solve entirely on-shard.
* Contribution order per interface matches the single-device pipeline,
  so results are bit-identical modulo XLA scheduling.

``ShardedLevel`` implements ``apply`` / ``smooth`` / ``smooth_zero``;
``ShardedTransfer`` implements the GMG ``restrict`` / ``prolong_add`` with
the same per-offset exchange for cross-shard parent/child pairs.
Communication volume is asserted against ``partition.cut_faces`` in the
tests.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map as _shard_map


def shard_map(f, mesh, in_specs, out_specs):
    return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      check_vma=False)


from ..gmg import _axis_matmul
from ..ops.level_ops import Level, _arr_axis, extract_faces
from ..ops import transforms as tr


def _placement_matrix(n: int, half: int) -> np.ndarray:
    """[n, n/2] 0/1 matrix placing a pooled child line into the
    (half)-orthant of the parent line."""
    E = np.zeros((n, n // 2))
    for j in range(n // 2):
        E[j + half * (n // 2), j] = 1.0
    return E


class Exchange:
    """Per-offset ``ppermute`` exchange of entity rows over the mesh axis.

    ``sends[(q, r)]`` is an ordered list of *sender-local* row ids that
    shard ``q`` must deliver to shard ``r``.  Rows land on the receiver in
    a deterministic buffer layout: ``[local rows | offset d0 rows |
    offset d1 rows | ... | zero pad row]``; ``recv_index(r, q, row)``
    returns the receiver-buffer position of a sent row.
    """

    def __init__(self, ndev: int, n_local_rows: int,
                 sends: Dict[Tuple[int, int], List[int]]):
        self.ndev = ndev
        self.n_local = n_local_rows
        offsets = sorted({(r - q) % ndev for (q, r) in sends if sends[(q, r)]})
        self.offsets = offsets
        self.send_tbl: List[np.ndarray] = []  # per offset: [ndev, Rd]
        self.widths: List[int] = []
        self._pos: Dict[Tuple[int, int, int], int] = {}
        base = n_local_rows
        self.comm_rows = 0  # true (unpadded) cut-entity rows
        for d in offsets:
            Rd = max(len(sends.get((q, (q + d) % ndev), [])) for q in range(ndev))
            tbl = np.full((ndev, Rd), n_local_rows, dtype=np.int32)  # pad->zero row
            for q in range(ndev):
                rows = sends.get((q, (q + d) % ndev), [])
                self.comm_rows += len(rows)
                tbl[q, : len(rows)] = rows
                for k, row in enumerate(rows):
                    self._pos[((q + d) % ndev, q, row)] = base + k
            self.send_tbl.append(tbl)
            self.widths.append(Rd)
            base += Rd
        self.buf_rows = base  # before the final zero row
        self._send_tbl_j = [jnp.asarray(t) for t in self.send_tbl]

    def recv_index(self, r: int, q: int, row: int) -> int:
        """Receiver-buffer position of sender ``q``'s local ``row`` on ``r``."""
        return self._pos[(r, q, row)]

    def run(self, local: jnp.ndarray, me) -> jnp.ndarray:
        """Inside shard_map: exchange and return the combined buffer
        ``[local | recv_d0 | ... | zero row]`` (shape ``[buf_rows+1, ...]``)."""
        zero = jnp.zeros((1,) + local.shape[1:], dtype=local.dtype)
        local_pad = jnp.concatenate([local, zero], axis=0)
        parts = [local]
        for d, tbl in zip(self.offsets, self._send_tbl_j):
            rows = local_pad[tbl[me]]  # [Rd, ...] this shard's batch to send
            perm = [(q, (q + d) % self.ndev) for q in range(self.ndev)]
            parts.append(jax.lax.ppermute(rows, "p", perm))
        parts.append(zero)
        return jnp.concatenate(parts, axis=0)


def _shard_of(P: int, ndev: int) -> np.ndarray:
    assert P % ndev == 0, f"pad the level first: P={P} % {ndev} != 0"
    return np.arange(P) // (P // ndev)


class ShardedLevel:
    """Level ops over a 1D mesh with explicit cut-face halo exchange.

    Drop-in for :class:`~pressurepoissonsolver_tpu.ops.level_ops.Level`
    inside GMG cycles and Krylov loops: exposes ``apply``, ``smooth``,
    ``smooth_zero``, ``patch_solve_gamma0``, ``zeros`` on *global*
    ``[P, *ns]`` arrays (sharded on the patch axis).
    """

    def __init__(self, level: Level, mesh: Mesh):
        self.base = level
        self.mesh = mesh
        self.ndev = int(np.prod(mesh.devices.shape))
        ndev = self.ndev
        lvl, t = level, level.tables
        D, n, m, S2 = lvl.D, lvl.n, lvl.m, 2 * lvl.D
        Pg = lvl.P
        self.D, self.n, self.m, self.P = D, n, m, Pg
        self.dtype = lvl.dtype
        self.pl = lvl.pl
        self.Pl = Pg // ndev
        Pl = self.Pl
        shard_of = _shard_of(Pg, ndev)
        self._psh = NamedSharding(mesh, P("p"))
        # face rows per patch (higher-order closures source inner faces too)
        self.face_depth = getattr(t, "face_depth", 1)
        S2f = S2 * self.face_depth

        # ---- contribution bookkeeping (case-sorted, as in Level) ----------
        order = np.argsort(t.contrib_case, kind="stable")
        c_patch = t.contrib_patch[order]
        c_side = t.contrib_side[order]
        c_iface = t.contrib_iface[order]
        c_case = t.contrib_case[order]
        C = len(c_patch)
        ncase = t.case_w.shape[0]

        # readers of each interface = shards of patches whose own-side
        # interface it is (every patch reads only its own side interfaces)
        readers: Dict[int, set] = {}
        for p in range(Pg):
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    readers.setdefault(int(t.iface_side_idx[p, s]), set()).add(
                        int(shard_of[p])
                    )

        # cut faces: remote contributions' (patch, side) face rows, dedup per
        # (sender, receiver, face row)
        sends: Dict[Tuple[int, int], List[int]] = {}
        sent: set = set()
        for c in range(C):
            p, s = int(c_patch[c]), int(c_side[c])
            q = int(shard_of[p])
            local_row = (p - q * Pl) * S2f + s
            for r in readers.get(int(c_iface[c]), ()):  # shards needing it
                if r == q:
                    continue
                key = (q, r, local_row)
                if key in sent:
                    continue
                sent.add(key)
                sends.setdefault((q, r), []).append(local_row)
        for v in sends.values():
            v.sort()
        self.exchange = Exchange(ndev, Pl * S2f, sends)
        self.comm_rows = self.exchange.comm_rows

        # ---- per-shard needed interfaces and contribution tables ----------
        need: List[List[int]] = [[] for _ in range(ndev)]
        for i, rs in sorted(readers.items()):
            for r in rs:
                need[r].append(i)
        loc_of = [
            {i: k for k, i in enumerate(lst)} for lst in need
        ]
        NIg = max((len(lst) for lst in need), default=0)
        self.NIg = NIg

        # ---- Schur gamma-vector sharding (interface ownership) ------------
        # The Schur path iterates on the interface vector itself, so gamma
        # gets a first-class sharded layout: owner = lowest reader shard
        # (the analog of the reference's lower-side-patch ownership,
        # ``SchurInfo.h:141-150``); the global vector is ``[ndev*NOg, m]``
        # with shard r's owned interfaces in block r (zero-padded).
        owner = {i: min(rs) for i, rs in readers.items()}
        owned: List[List[int]] = [
            [i for i in need[r] if owner[i] == r] for r in range(ndev)
        ]
        self._owned_ids = owned
        self.NOg = max((len(o) for o in owned), default=0)
        NOg = max(self.NOg, 1)
        own_pos = np.full((ndev, NOg), max(NIg, 1), dtype=np.int32)  # pad row
        gslot: Dict[int, int] = {}
        for r in range(ndev):
            for k, i in enumerate(owned[r]):
                own_pos[r, k] = loc_of[r][i]
                gslot[i] = k
        self._own_pos = jnp.asarray(own_pos)
        # exchange of owned gamma rows to their remote readers
        gsends: Dict[Tuple[int, int], List[int]] = {}
        for i, rs in sorted(readers.items()):
            q = owner[i]
            for r in rs:
                if r != q:
                    gsends.setdefault((q, r), []).append(gslot[i])
        for v in gsends.values():
            v.sort()
        self.ex_gamma = Exchange(ndev, NOg, gsends)
        # per-patch-side position in the gamma exchange buffer
        gifidx = np.full((ndev, Pl, S2), self.ex_gamma.buf_rows, dtype=np.int32)
        for p in range(Pg):
            r = int(shard_of[p])
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    i = int(t.iface_side_idx[p, s])
                    q = owner[i]
                    gifidx[r, p - r * Pl, s] = (
                        gslot[i] if q == r
                        else self.ex_gamma.recv_index(r, q, gslot[i])
                    )
        self._gifidx = jnp.asarray(gifidx)

        # per shard, per case: contribution entries (src buffer row, iface)
        percase: List[List[List[Tuple[int, int]]]] = [
            [[] for _ in range(ncase)] for _ in range(ndev)
        ]
        for c in range(C):
            p, s = int(c_patch[c]), int(c_side[c])
            q = int(shard_of[p])
            i = int(c_iface[c])
            k = int(c_case[c])
            local_row = (p - q * Pl) * S2f + s
            for r in readers.get(i, ()):  # compute on every reader shard
                src = (
                    local_row
                    if r == q
                    else self.exchange.recv_index(r, q, local_row)
                )
                percase[r][k].append((src, loc_of[r][i]))
        Ck = [
            max(len(percase[r][k]) for r in range(ndev)) for k in range(ncase)
        ]
        Ctot = sum(Ck)
        buf_pad = self.exchange.buf_rows  # index of the zero row
        csrc = np.full((ndev, max(Ctot, 1)), buf_pad, dtype=np.int32)
        cif = np.full((ndev, max(Ctot, 1)), NIg, dtype=np.int32)  # NIg = trash
        segs = []
        pos = 0
        for k in range(ncase):
            segs.append((k, pos, pos + Ck[k]))
            for r in range(ndev):
                for j, (src, li) in enumerate(percase[r][k]):
                    csrc[r, pos + j] = src
                    cif[r, pos + j] = li
            pos += Ck[k]
        self._segs = [(k, a, b) for (k, a, b) in segs if b > a]
        self._csrc = jnp.asarray(csrc)

        # per-iface gather of contribution positions (same order as Level)
        Kif = 1
        by_iface = [
            [[] for _ in range(NIg)] for _ in range(ndev)
        ]
        for r in range(ndev):
            pos = 0
            for k in range(ncase):
                for j in range(Ck[k]):
                    li = cif[r, pos + j]
                    if li < NIg:
                        by_iface[r][li].append(pos + j)
                pos += Ck[k]
            for lst in by_iface[r]:
                Kif = max(Kif, len(lst))
        gath = np.full((ndev, max(NIg, 1), Kif), max(Ctot, 1), dtype=np.int32)
        for r in range(ndev):
            for li, lst in enumerate(by_iface[r]):
                gath[r, li, : len(lst)] = lst
        self._gath = jnp.asarray(gath)

        # per-patch-side local interface slots (+ mask)
        ifidx = np.full((ndev, Pl, S2), max(NIg, 1), dtype=np.int32)
        imask = np.zeros((ndev, Pl, S2), dtype=bool)
        for p in range(Pg):
            r = int(shard_of[p])
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    ifidx[r, p - r * Pl, s] = loc_of[r][int(t.iface_side_idx[p, s])]
                    imask[r, p - r * Pl, s] = True
        self._ifidx = jnp.asarray(ifidx)
        self._imask = jnp.asarray(imask)

        # ---- direct gf tables (apply/smooth fast path) ---------------------
        # Same observation as Level._build_gf_tables: on a same-level
        # interface ghost = u_nbr, so gf = 0.5*own + 0.5*nbr where the nbr
        # face row is already in the cut-face exchange buffer; only the
        # refinement-boundary interfaces run the contribution pipeline.
        by_if: Dict[int, List[int]] = {}
        for c in range(C):
            by_if.setdefault(int(c_iface[c]), []).append(c)
        scalar_of = lvl._case_scalar
        fd = self.face_depth
        g_readers: Dict[int, List[Tuple[int, int]]] = {}
        for p in range(Pg):
            for s in range(S2):
                if t.iface_side_mask[p, s]:
                    g_readers.setdefault(
                        int(t.iface_side_idx[p, s]), []
                    ).append((p, s))
        direct: Dict[int, List[int]] = {}
        for i, lst in by_if.items():
            if len(lst) != 2 or len(g_readers.get(i, ())) != 2:
                continue
            ok = all(
                scalar_of[int(c_case[c])] == 0.5
                and int(c_side[c]) % fd == 0
                for c in lst
            )
            crows = {
                int(c_patch[c]) * S2f + int(c_side[c]) for c in lst
            }
            orows = {p * S2f + s * fd for p, s in g_readers[i]}
            if ok and crows == orows:
                direct[i] = lst
        # per-shard refinement interfaces (compact numbering)
        need_ref = [[i for i in lst if i not in direct] for lst in need]
        loc_ref = [{i: k for k, i in enumerate(lst)} for lst in need_ref]
        NRg = max((len(lst) for lst in need_ref), default=0)
        self.NRg = NRg
        # restricted contribution tables (refinement ifaces only)
        percase_r: List[List[List[Tuple[int, int]]]] = [
            [[] for _ in range(ncase)] for _ in range(ndev)
        ]
        for c in range(C):
            i = int(c_iface[c])
            if i in direct:
                continue
            p, s = int(c_patch[c]), int(c_side[c])
            q = int(shard_of[p])
            k = int(c_case[c])
            local_row = (p - q * Pl) * S2f + s
            for r in readers.get(i, ()):
                src = (
                    local_row if r == q
                    else self.exchange.recv_index(r, q, local_row)
                )
                percase_r[r][k].append((src, loc_ref[r][i]))
        Ck_r = [
            max(len(percase_r[r][k]) for r in range(ndev))
            for k in range(ncase)
        ]
        Ctot_r = sum(Ck_r)
        csrc_r = np.full((ndev, max(Ctot_r, 1)), buf_pad, dtype=np.int32)
        segs_r = []
        by_if_r = [[[] for _ in range(max(NRg, 1))] for _ in range(ndev)]
        pos = 0
        Kif_r = 1
        for k in range(ncase):
            if Ck_r[k]:
                segs_r.append((k, pos, pos + Ck_r[k]))
            for r in range(ndev):
                for j, (src, li) in enumerate(percase_r[r][k]):
                    csrc_r[r, pos + j] = src
                    by_if_r[r][li].append(pos + j)
            pos += Ck_r[k]
        for r in range(ndev):
            for lst in by_if_r[r]:
                Kif_r = max(Kif_r, len(lst))
        gath_r = np.full((ndev, max(NRg, 1), Kif_r), max(Ctot_r, 1),
                         dtype=np.int32)
        for r in range(ndev):
            for li, lst in enumerate(by_if_r[r]):
                gath_r[r, li, : len(lst)] = lst
        self._segs_ref = segs_r
        self._csrc_ref = jnp.asarray(csrc_r)
        self._gath_ref = jnp.asarray(gath_r)
        # per-side source into [buf | gamma_ref | implicit zero via buf pad]
        buf_zero = self.exchange.buf_rows  # the zero row of the buffer
        gfsrc = np.full((ndev, Pl, S2), buf_zero, dtype=np.int32)
        gfw_own = np.zeros((ndev, Pl, S2, 1))
        gfw_mix = np.zeros((ndev, Pl, S2, 1))
        for p in range(Pg):
            r = int(shard_of[p])
            pl_ = p - r * Pl
            for s in range(S2):
                if not t.iface_side_mask[p, s]:
                    continue
                i = int(t.iface_side_idx[p, s])
                if i in direct:
                    own_row = pl_ * S2f + s * fd
                    rows = []
                    for c in direct[i]:
                        cp, cs = int(c_patch[c]), int(c_side[c])
                        q = int(shard_of[cp])
                        lr = (cp - q * Pl) * S2f + cs
                        rows.append(
                            lr if q == r
                            else self.exchange.recv_index(r, q, lr)
                        )
                    rows.remove(own_row)
                    gfsrc[r, pl_, s] = rows[0]
                    gfw_own[r, pl_, s] = 0.5
                    gfw_mix[r, pl_, s] = 0.5
                else:
                    gfsrc[r, pl_, s] = buf_zero + 1 + loc_ref[r][i]
                    gfw_mix[r, pl_, s] = 1.0
        self._gfsrc = jnp.asarray(gfsrc)
        self._gfw_own = jnp.asarray(gfw_own)
        self._gfw_mix = jnp.asarray(gfw_mix)

        # ---- local spectral-solve data ------------------------------------
        pl = lvl.pl
        inv_perm = np.asarray(lvl._solver_inv_perm)
        self._denom = jnp.asarray(
            np.asarray(lvl._denom_sorted)[inv_perm]
        )  # slot order, [P, *ns]
        self._single_group = len(lvl._solve_groups) == 1
        self._kron = None
        if self._single_group:
            g = lvl._solve_groups[0]
            self._fwd = [lvl._tmats[k] for k in g.fwd_kinds]
            self._inv = [lvl._tmats[k] for k in g.inv_kinds]
            self._pin = g.pin_dc
            if lvl._st.kron:  # f32 fast path (see ops.level_ops)
                self._kron = lvl._st.kron[0]
        else:
            kinds = sorted(lvl._tmats.keys())
            kpos = {k: i for i, k in enumerate(kinds)}
            self._tstack = jnp.stack([lvl._tmats[k] for k in kinds])  # [nk,n,n]
            tidx = np.zeros((Pg, D, 2), dtype=np.int32)
            pin = np.zeros(Pg, dtype=bool)
            for p in range(Pg):
                for a in range(D):
                    f, i, _ = tr.axis_transforms(
                        bool(pl.neumann[p, 2 * a]), bool(pl.neumann[p, 2 * a + 1])
                    )
                    tidx[p, a] = (kpos[f], kpos[i])
                pin[p] = bool(np.all(pl.neumann[p]))
            self._tidx = jnp.asarray(tidx)
            self._pinmask = jnp.asarray(pin)

        self._jit = {}
        # merged case-template matmul (_case_parts): one [m, ncase*m] W
        # for every matmul case either pipeline uses, built eagerly here
        # (inside shard_map the closed-over case_T constants are tracers)
        mm_all = sorted({
            k for segs in (self._segs, self._segs_ref)
            for (k, _a, _b) in segs if lvl._case_scalar[k] is None
        })
        if mm_all:
            W = np.concatenate(
                [np.asarray(lvl._case_T[k]).T for k in mm_all], axis=1
            )
            self._Wall = jnp.asarray(W)
            self._wall_col = {k: j for j, k in enumerate(mm_all)}
        else:
            self._Wall = None
            self._wall_col = {}

    # -- inside-shard pieces -------------------------------------------------

    def _case_parts(self, g, dtype, segs):
        """Per-segment contribution values for the case-sorted source rows
        ``g [Ctot, m]``: scalar cases (normal/c2c) stay elementwise; ALL
        matmul cases (refinement closures) come out of ONE
        ``[Ctot, m] @ [m, ncase*m]`` matmul in true f32 whose case block
        is sliced per segment — a handful of tiny per-seg GEMMs is
        launch-bound (same merge as ``ops.level_ops._ContribPipeline``;
        the wasted scalar-row flops are small)."""
        lvl = self.base
        m = self.m
        col = self._wall_col
        vals_all = None
        if any(lvl._case_scalar[k] is None for k, a, b in segs):
            vals_all = jnp.matmul(
                g, self._Wall.astype(dtype),
                precision=jax.lax.Precision.HIGHEST,
            )
        parts = []
        for k, a, b in segs:
            w = lvl._case_scalar[k]
            if w is not None:
                rows = jax.lax.slice_in_dim(g, a, b, axis=0)
                parts.append(rows * jnp.asarray(w, dtype=dtype))
            else:
                j = col[k]
                parts.append(
                    jax.lax.slice(vals_all, (a, j * m), (b, (j + 1) * m))
                )
        return parts

    def _interp_local(self, u_loc, me):
        """Exchange cut faces and compute this shard's needed interface
        values, zero-padded: ``[NIg+1, m]`` (last row = zero)."""
        lvl = self.base
        D, n, m = self.D, self.n, self.m
        faces = extract_faces(u_loc, D, n, self.face_depth).reshape(-1, m)
        buf = self.exchange.run(faces, me)  # [buf_rows+1, m]
        g = buf[self._csrc[me]]  # [Ctot, m]
        parts = self._case_parts(g, u_loc.dtype, self._segs)
        if parts:
            vals = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        else:
            vals = jnp.zeros((1, m), dtype=u_loc.dtype)
        vals_pad = jnp.concatenate(
            [vals, jnp.zeros((1, m), dtype=vals.dtype)], axis=0
        )
        gamma = jnp.sum(vals_pad[self._gath[me]], axis=1)  # [NIg(,1), m]
        return jnp.concatenate(
            [gamma, jnp.zeros((1, m), dtype=gamma.dtype)], axis=0
        )

    def _gamma_faces_local(self, u_loc, me):
        """Exchange cut faces and compute this shard's gf [Pl, 2D, m]."""
        gamma_pad = self._interp_local(u_loc, me)
        gf = gamma_pad[self._ifidx[me]]  # [Pl, 2D, m]
        return gf * self._imask[me][..., None].astype(gf.dtype)

    def _gf_direct_parts(self, u_loc, me):
        """``(w_mix * mix, own)`` of the direct pipeline, both
        ``[Pl, 2D, m]``: direct sides read the neighbor face row straight
        from the exchange buffer (gf = 0.5 own + 0.5 nbr); refinement
        sides run the compact contribution pipeline."""
        D, n, m = self.D, self.n, self.m
        Pl = u_loc.shape[0]
        S2 = 2 * D
        faces = extract_faces(u_loc, D, n, self.face_depth)
        buf = self.exchange.run(faces.reshape(-1, m), me)
        own = faces.reshape(Pl, S2, self.face_depth, m)[:, :, 0]
        if self.NRg:
            g = buf[self._csrc_ref[me]]
            parts = self._case_parts(g, u_loc.dtype, self._segs_ref)
            vals = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
            vp = jnp.concatenate(
                [vals, jnp.zeros((1, m), dtype=vals.dtype)], axis=0
            )
            gref = jnp.sum(vp[self._gath_ref[me]], axis=1)  # [NRg, m]
            combined = jnp.concatenate([buf, gref], axis=0)
        else:
            combined = buf
        mix = combined[self._gfsrc[me].reshape(-1)].reshape(Pl, S2, m)
        return self._gfw_mix[me].astype(u_loc.dtype) * mix, own

    def _gf_direct_local(self, u_loc, me):
        """gf [Pl, 2D, m] via the direct pipeline.  Same values as
        ``_gamma_faces_local``."""
        mix_scaled, own = self._gf_direct_parts(u_loc, me)
        return self._gfw_own[me].astype(u_loc.dtype) * own + mix_scaled

    def _gf_from_gamma_local(self, g_loc, me):
        """gf [Pl, 2D, m] from this shard's owned-gamma block (exchanging
        remote-owned rows point-to-point)."""
        buf = self.ex_gamma.run(g_loc, me)
        gf = buf[self._gifidx[me]]
        return gf * self._imask[me][..., None].astype(gf.dtype)

    def _stencil_local(self, u_loc, gf, h2inv, coef):
        """Ghost-closure stencil, split into an exchange-independent base
        (ghost = c*u_b) plus face corrections ``+= 2 h^-2 gf``.

        The base term has no data dependency on the halo exchange, so
        XLA's latency-hiding scheduler is free to overlap the interior
        stencil compute with the in-flight ``ppermute``s — the BASELINE
        "halo collectives overlapped with interior stencil compute"
        schedule, obtained by dependency structure instead of manual
        double buffering."""
        D, n = self.D, self.n
        Pl = u_loc.shape[0]
        out = jnp.zeros_like(u_loc)
        for a in range(D):
            ax = _arr_axis(D, a)
            u_lo = jnp.take(u_loc, 0, axis=ax)
            u_hi = jnp.take(u_loc, n - 1, axis=ax)
            c_lo = coef[:, 2 * a].reshape((Pl,) + (1,) * (D - 1))
            c_hi = coef[:, 2 * a + 1].reshape((Pl,) + (1,) * (D - 1))
            lo = jnp.concatenate(
                [jnp.expand_dims(c_lo * u_lo, ax),
                 jax.lax.slice_in_dim(u_loc, 0, n - 1, axis=ax)], axis=ax)
            hi = jnp.concatenate(
                [jax.lax.slice_in_dim(u_loc, 1, n, axis=ax),
                 jnp.expand_dims(c_hi * u_hi, ax)], axis=ax)
            h2i = h2inv[:, a].reshape((Pl,) + (1,) * D)
            out = out + (lo - 2.0 * u_loc + hi) * h2i
        # face corrections (the only exchange-dependent term), pad-spread
        # form — the .at[].add slice-update form costs a full-array copy
        # per side.
        # The barrier keeps the exchange-independent base term its own
        # fusion so the scheduler can run it inside the in-flight
        # ppermute windows (one materialization instead of four;
        # without it XLA fuses base+correction into one fusion that
        # waits on the exchange).
        from ..ops.level_ops import _face_pad_sum

        if self.ndev > 1:
            # no exchange to overlap at ndev=1 — the barrier would only
            # force an extra materialization of the base term
            out = jax.lax.optimization_barrier(out)
        add = _face_pad_sum(gf, h2inv, D, n, u_loc.dtype)
        return out + 2.0 * add if add is not None else out

    def _fold_local(self, fc, gf, h2inv):
        from ..ops.level_ops import _fold_faces_flat

        return _fold_faces_flat(fc, gf, h2inv, self.D, self.n)

    def _solve_local(self, fc, denom, tidx=None, pinmask=None):
        """Local batched spectral solve in patch-slot order."""
        D, n = self.D, self.n
        x = fc
        scale = (2.0 / n) ** D
        if self._single_group:
            if self._kron is not None:  # f32 Kronecker fast path
                Pl = x.shape[0]
                cells = int(np.prod(x.shape[1:]))
                xf = x.reshape(Pl, cells)
                if D == 2:
                    W1, W2 = self._kron
                    y = (xf @ W1.astype(x.dtype)) / denom.reshape(Pl, cells)
                    if self._pin:
                        y = y.at[:, 0].set(0.0)
                    return (y @ W2.astype(x.dtype)).reshape(x.shape)
                W1, W2, Tz1, Tz2 = self._kron
                x3 = xf.reshape(Pl, n, cells // n)
                y = jnp.einsum("pwl,zw->pzl", x3, Tz1.astype(x.dtype))
                y = (y @ W1.astype(x.dtype)) / denom.reshape(Pl, n, cells // n)
                if self._pin:
                    y = y.at[:, 0, 0].set(0.0)
                y = jnp.einsum("pwl,zw->pzl", y, Tz2.astype(x.dtype))
                return (y @ W2.astype(x.dtype)).reshape(x.shape)
            for a in range(D):
                x = Level._apply_transform(
                    self._fwd[a].astype(x.dtype), x, _arr_axis(D, a)
                )
            x = x / denom
            if self._pin:
                zero_idx = (slice(None),) + (0,) * D
                x = x.at[zero_idx].set(0.0)
            for a in range(D):
                x = Level._apply_transform(
                    self._inv[a].astype(x.dtype), x, _arr_axis(D, a)
                )
            return x * scale
        # general path: per-patch gathered transform matrices
        ts = self._tstack.astype(x.dtype)
        for a in range(D):
            T = ts[tidx[:, a, 0]]  # [Pl, n, n]
            x = self._bmm(T, x, _arr_axis(D, a))
        x = x / denom
        zero_idx = (slice(None),) + (0,) * D
        x = x.at[zero_idx].set(
            jnp.where(pinmask, 0.0, x[zero_idx])
        )
        for a in range(D):
            T = ts[tidx[:, a, 1]]
            x = self._bmm(T, x, _arr_axis(D, a))
        return x * scale

    @staticmethod
    def _bmm(T, x, ax):
        """Per-patch transform along array axis ``ax``: x @ T[p].T."""
        n = T.shape[-1]
        moved = jnp.moveaxis(x, ax, -1)
        shape = moved.shape
        flat = moved.reshape(shape[0], -1, n)  # [Pl, q, n]
        y = jnp.einsum("pqn,pmn->pqm", flat, T)
        return jnp.moveaxis(y.reshape(shape), -1, ax)

    # -- public ops on global arrays -----------------------------------------

    def _smap(self, name, fn, nargs):
        key = name
        if key not in self._jit:
            specs = (P("p"),) * nargs
            self._jit[key] = jax.jit(
                shard_map(fn, self.mesh, in_specs=specs, out_specs=P("p"))
            )
        return self._jit[key]

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        """Composite operator with explicit cut-face exchange.

        Same own-face fold as ``Level.apply``: the stencil uses the
        effective ghost coefficient (``c + 2*w_own``, 0 on direct sides)
        and consumes the w_mix-scaled exchange term directly."""
        def f(u_loc, h2inv, coef_eff):
            me = jax.lax.axis_index("p")
            mix_scaled, _ = self._gf_direct_parts(u_loc, me)
            return self._stencil_local(u_loc, mix_scaled, h2inv, coef_eff)

        return self._smap("apply", f, 3)(
            u, self.base.h2inv.astype(u.dtype),
            self.base.ghost_coef_eff.astype(u.dtype)
        )

    def smooth(self, f: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """One block-Jacobi sweep with explicit cut-face exchange."""
        if self._single_group:
            def g(f_loc, u_loc, h2inv, denom):
                me = jax.lax.axis_index("p")
                gf = self._gf_direct_local(u_loc, me)
                fc = self._fold_local(f_loc, gf, h2inv)
                return self._solve_local(fc, denom)

            return self._smap("smooth", g, 4)(
                f, u, self.base.h2inv.astype(f.dtype), self._denom.astype(f.dtype)
            )

        def g(f_loc, u_loc, h2inv, denom, tidx, pinmask):
            me = jax.lax.axis_index("p")
            gf = self._gf_direct_local(u_loc, me)
            fc = self._fold_local(f_loc, gf, h2inv)
            return self._solve_local(fc, denom, tidx, pinmask)

        return self._smap("smooth_mg", g, 6)(
            f, u, self.base.h2inv.astype(f.dtype), self._denom.astype(f.dtype),
            self._tidx, self._pinmask,
        )

    def smooth_zero(self, f: jnp.ndarray) -> jnp.ndarray:
        """``smooth(f, 0)`` — no interface traces, pure local solves."""
        if self._single_group:
            def g(f_loc, denom):
                return self._solve_local(f_loc, denom)

            return self._smap("smooth0", g, 2)(f, self._denom.astype(f.dtype))

        def g(f_loc, denom, tidx, pinmask):
            return self._solve_local(f_loc, denom, tidx, pinmask)

        return self._smap("smooth0_mg", g, 4)(
            f, self._denom.astype(f.dtype), self._tidx, self._pinmask
        )

    # -- Schur interface path (reference SchurHelper, SchurHelper.h:215-331;
    #    here the gamma vector itself is sharded by interface owner) --------

    def gamma_zeros(self, dtype=None) -> jnp.ndarray:
        """Zero interface vector in the sharded owner layout
        ``[ndev*NOg, m]`` (shard r's block = its owned interfaces)."""
        z = jnp.zeros(
            (self.ndev * max(self.NOg, 1), self.m), dtype=dtype or self.dtype
        )
        return jax.device_put(z, self._psh)

    def gamma_global(self, gamma) -> np.ndarray:
        """Owner-sharded gamma -> the single-device ``[NIf, m]`` layout
        (host-side; for tests/IO)."""
        NOg = max(self.NOg, 1)
        out = np.zeros((self.base.num_ifaces, self.m), dtype=gamma.dtype)
        g = np.asarray(gamma)
        for r, ids in enumerate(self._owned_ids):
            for k, i in enumerate(ids):
                out[i] = g[r * NOg + k]
        return out

    def interpolate(self, u: jnp.ndarray) -> jnp.ndarray:
        """Trace interpolation into the owner-sharded gamma layout."""
        def f(u_loc):
            me = jax.lax.axis_index("p")
            gamma_pad = self._interp_local(u_loc, me)
            return gamma_pad[self._own_pos[me]]  # [NOg, m]

        return self._smap("interp", f, 1)(u)

    def patch_solve(self, f: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """Batched patch solves with explicit owner-sharded interface
        values (fold ``-2 h^-2 gamma`` into f, then spectral solves)."""
        if self._single_group:
            def g(f_loc, g_loc, h2inv, denom):
                me = jax.lax.axis_index("p")
                gf = self._gf_from_gamma_local(g_loc, me)
                fc = self._fold_local(f_loc, gf, h2inv)
                return self._solve_local(fc, denom)

            return self._smap("psolve", g, 4)(
                f, gamma.astype(f.dtype), self.base.h2inv.astype(f.dtype),
                self._denom.astype(f.dtype),
            )

        def g(f_loc, g_loc, h2inv, denom, tidx, pinmask):
            me = jax.lax.axis_index("p")
            gf = self._gf_from_gamma_local(g_loc, me)
            fc = self._fold_local(f_loc, gf, h2inv)
            return self._solve_local(fc, denom, tidx, pinmask)

        return self._smap("psolve_mg", g, 6)(
            f, gamma.astype(f.dtype), self.base.h2inv.astype(f.dtype),
            self._denom.astype(f.dtype), self._tidx, self._pinmask,
        )

    def fold_gamma(self, f: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        """``f - 2 h^-2 gamma`` spread onto every neighbored face row
        (``StarPatchOp::addInterfaceToRHS`` without the solve) — the ghost
        injection ``f - G gamma`` used by the Schur-GMG preconditioner."""
        def g(f_loc, g_loc, h2inv):
            me = jax.lax.axis_index("p")
            gf = self._gf_from_gamma_local(g_loc, me)
            return self._fold_local(f_loc, gf, h2inv)

        return self._smap("foldg", g, 3)(
            f, gamma.astype(f.dtype), self.base.h2inv.astype(f.dtype)
        )

    def schur_S(self, gamma: jnp.ndarray) -> jnp.ndarray:
        """``S gamma = interp(patch_solve(0, gamma))`` in one shard_map
        (one gamma exchange + one cut-face exchange per application) —
        the matrix-free Schur operator of ``SchurWrapOp.h:47-53``."""
        if self._single_group:
            def g(g_loc, h2inv, denom):
                me = jax.lax.axis_index("p")
                gf = self._gf_from_gamma_local(g_loc, me)
                zf = jnp.zeros((self.Pl,) + (self.n,) * self.D, dtype=g_loc.dtype)
                u = self._solve_local(self._fold_local(zf, gf, h2inv), denom)
                return self._interp_local(u, me)[self._own_pos[me]]

            return self._smap("schurS", g, 3)(
                gamma, self.base.h2inv.astype(gamma.dtype),
                self._denom.astype(gamma.dtype),
            )

        def g(g_loc, h2inv, denom, tidx, pinmask):
            me = jax.lax.axis_index("p")
            gf = self._gf_from_gamma_local(g_loc, me)
            zf = jnp.zeros((self.Pl,) + (self.n,) * self.D, dtype=g_loc.dtype)
            u = self._solve_local(
                self._fold_local(zf, gf, h2inv), denom, tidx, pinmask
            )
            return self._interp_local(u, me)[self._own_pos[me]]

        return self._smap("schurS_mg", g, 5)(
            gamma, self.base.h2inv.astype(gamma.dtype),
            self._denom.astype(gamma.dtype), self._tidx, self._pinmask,
        )

    def zeros(self) -> jnp.ndarray:
        z = jnp.zeros((self.P,) + self.pl.ns_shape, dtype=self.dtype)
        return jax.device_put(z, self._psh)

    def integrate(self, u):
        return self.base.integrate(u)

    @property
    def volume(self):
        return self.base.volume

    @property
    def num_ifaces(self):
        return self.base.num_ifaces


class ShardedActiveSmoother:
    """FAC active-set smoothing for a :class:`ShardedLevel`: per-shard
    subset compute instead of masked full sweeps.

    Each shard's active patches are padded to the max count across shards
    (``Amax``), so every shard runs the same-shaped program: gather the
    active rows, fold the interface traces, batch-solve only those
    patches, and route the solutions back with a padded row gather + mask.
    The interface values come from the level's standard cut-face exchange
    (``_interp_local``), so cross-shard trace sources need no extra
    bookkeeping.  This is the sharded counterpart of
    ``ops.level_ops.ActiveSmoother`` (classical FAC relaxation; the
    reference relaxes every patch of every level,
    ``GMG/FFTBlockJacobiSmoother.h:31-59``)."""

    def __init__(self, sl: ShardedLevel, active: np.ndarray):
        self.sl = sl
        ndev, Pl, D, n = sl.ndev, sl.Pl, sl.D, sl.n
        self.D, self.n = D, n
        pl = sl.pl
        act_by = [
            np.where(active[r * Pl:(r + 1) * Pl])[0] for r in range(ndev)
        ]
        self.Amax = Amax = max(max((len(a) for a in act_by), default=0), 1)
        # pad slots index row 0 (a valid in-range row: _rows gathers from
        # the Pl-row local array with NO appended pad row, so an index of
        # Pl would rely on JAX's out-of-bounds clamp); their solves are
        # masked out by _scatter
        act = np.zeros((ndev, Amax), dtype=np.int32)
        inv = np.full((ndev, Pl), Amax, dtype=np.int32)  # pad -> zero row
        mask = np.zeros((ndev, Pl), dtype=bool)
        ns = pl.ns_shape
        h2 = np.asarray(sl.base.h2inv, dtype=np.float64)
        coef = np.asarray(sl.base.ghost_coef, dtype=np.float64)
        denom = np.asarray(sl._denom, dtype=np.float64)
        ifidx = np.asarray(sl._ifidx)
        imask = np.asarray(sl._imask)
        h2a = np.ones((ndev, Amax, D))
        coefa = np.zeros((ndev, Amax, 2 * D))
        dena = np.ones((ndev, Amax) + ns)
        gfi = np.full((ndev, Amax, 2 * D), ifidx.max(initial=1), dtype=np.int32)
        gfm = np.zeros((ndev, Amax, 2 * D), dtype=bool)
        for r, sel in enumerate(act_by):
            k = len(sel)
            act[r, :k] = sel
            inv[r, sel] = np.arange(k)
            mask[r, sel] = True
            gsel = sel + r * Pl
            h2a[r, :k] = h2[gsel]
            coefa[r, :k] = coef[gsel]
            dena[r, :k] = denom[gsel]
            gfi[r, :k] = ifidx[r, sel]
            gfm[r, :k] = imask[r, sel]
        f = jnp.asarray
        self._act = f(act)
        self._inv = f(inv)
        self._mask = f(mask.reshape((ndev, Pl) + (1,) * D))
        self._h2a = f(h2a)
        self._coefa = f(coefa)
        self._dena = f(dena)
        self._gfi = f(gfi)
        self._gfm = f(gfm)
        if not sl._single_group:
            tidx = np.asarray(sl._tidx)
            pin = np.asarray(sl._pinmask)
            ta = np.zeros((ndev, Amax, D, 2), dtype=np.int32)
            pa = np.zeros((ndev, Amax), dtype=bool)
            for r, sel in enumerate(act_by):
                gsel = sel + r * Pl
                ta[r, : len(sel)] = tidx[gsel]
                pa[r, : len(sel)] = pin[gsel]
            self._tidxa = f(ta)
            self._pina = f(pa)
        self._jit = {}

    @staticmethod
    def _rows(x, idx):
        """Leading-axis gather through the flattened rank-2 view."""
        return x.reshape(x.shape[0], -1)[idx].reshape(
            (idx.shape[0],) + x.shape[1:]
        )

    def _gf_act(self, gamma_pad, me, dtype):
        gf = gamma_pad[self._gfi[me]]  # [Amax, 2D, m]
        return gf * self._gfm[me][..., None].astype(dtype)

    def _solve_subset(self, fa, me):
        sl = self.sl
        if sl._single_group:
            return sl._solve_local(fa, self._dena[me].astype(fa.dtype))
        return sl._solve_local(
            fa, self._dena[me].astype(fa.dtype), self._tidxa[me], self._pina[me]
        )

    def _scatter(self, sol, me, base):
        pad = jnp.zeros((1,) + sol.shape[1:], dtype=sol.dtype)
        routed = self._rows(jnp.concatenate([sol, pad], axis=0), self._inv[me])
        return jnp.where(self._mask[me], routed, base)

    def _smap(self, name, fn, nargs):
        if name not in self._jit:
            self._jit[name] = jax.jit(
                shard_map(fn, self.sl.mesh, in_specs=(P("p"),) * nargs,
                          out_specs=P("p"))
            )
        return self._jit[name]

    def smooth(self, f: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        from ..ops.level_ops import _fold_faces_flat

        def g(f_loc, u_loc):
            me = jax.lax.axis_index("p")
            gamma_pad = self.sl._interp_local(u_loc, me)
            fa = self._rows(f_loc, self._act[me])
            gf = self._gf_act(gamma_pad, me, f_loc.dtype)
            fa = _fold_faces_flat(fa, gf, self._h2a[me].astype(f_loc.dtype),
                                  self.D, self.n)
            return self._scatter(self._solve_subset(fa, me), me, u_loc)

        return self._smap("smooth", g, 2)(f, u)

    def smooth_zero(self, f: jnp.ndarray) -> jnp.ndarray:
        def g(f_loc):
            me = jax.lax.axis_index("p")
            fa = self._rows(f_loc, self._act[me])
            sol = self._solve_subset(fa, me)
            return self._scatter(sol, me, jnp.zeros((), dtype=f_loc.dtype))

        return self._smap("smooth0", g, 1)(f)

    def apply_scattered(self, u: jnp.ndarray) -> jnp.ndarray:
        """``A u`` on the subset, scattered into zeros (see
        ``ActiveSmoother.apply_scattered`` for the exactness condition)."""
        from ..ops.level_ops import _star_stencil

        def g(u_loc):
            me = jax.lax.axis_index("p")
            gamma_pad = self.sl._interp_local(u_loc, me)
            ua = self._rows(u_loc, self._act[me])
            gf = self._gf_act(gamma_pad, me, u_loc.dtype)
            out = _star_stencil(
                ua, gf, self._coefa[me].astype(u_loc.dtype),
                self._h2a[me].astype(u_loc.dtype), self.D, self.n,
            )
            return self._scatter(out, me, jnp.zeros((), dtype=u_loc.dtype))

        return self._smap("apply_sc", g, 1)(u)


class ShardedTransfer:
    """GMG restriction/prolongation with per-offset parent/child exchange.

    Mirrors :class:`~pressurepoissonsolver_tpu.gmg.Transfer` (cell-average
    restriction / constant or linear prolongation with pass-through
    copies); cross-shard parent-child pairs move pooled child blocks
    (restriction) or full parent patches (prolongation) point-to-point.
    """

    def __init__(self, transfer, fine: ShardedLevel, coarse: ShardedLevel):
        from ..domain import parent_slots

        self.t = transfer
        self.fine = fine
        self.coarse = coarse
        self.mesh = fine.mesh
        ndev = fine.ndev
        D, n = fine.D, fine.n
        self.D, self.n = D, n
        Pf, Pc = fine.P, coarse.P
        Pfl, Pcl = fine.Pl, coarse.Pl
        fshard = _shard_of(Pf, ndev)
        cshard = _shard_of(Pc, ndev)
        pslots = parent_slots(transfer.fine.pl, transfer.coarse.pl)
        passthrough = transfer.fine.pl.orth_on_parent < 0
        orth = transfer.fine.pl.orth_on_parent
        self.prolong_mode = transfer.prolong_mode

        # ---- restriction: children/pass-through -> parent shard -----------
        sends_pool: Dict[Tuple[int, int], List[int]] = {}
        sends_full: Dict[Tuple[int, int], List[int]] = {}
        child_info = []  # (fine slot, parent slot, orth, passthrough)
        for i in range(Pf):
            ps = pslots[i]
            if ps < 0:
                continue
            q, r = int(fshard[i]), int(cshard[ps])
            if q != r:
                tgt = sends_full if passthrough[i] else sends_pool
                lst = tgt.setdefault((q, r), [])
                if (i - q * Pfl) not in lst:
                    lst.append(i - q * Pfl)
            child_info.append((i, int(ps), int(orth[i]), bool(passthrough[i])))
        for v in sends_pool.values():
            v.sort()
        for v in sends_full.values():
            v.sort()
        self.ex_pool = Exchange(ndev, Pfl, sends_pool)
        self.ex_full = Exchange(ndev, Pfl, sends_full)
        self.comm_rows = self.ex_pool.comm_rows + self.ex_full.comm_rows

        # coarse-side assembly tables
        child_src = np.full((ndev, Pcl, 1 << D), self.ex_pool.buf_rows,
                            dtype=np.int32)
        pt_src = np.full((ndev, Pcl), self.ex_full.buf_rows, dtype=np.int32)
        for i, ps, o, pt in child_info:
            q, r = int(fshard[i]), int(cshard[ps])
            if pt:
                src = (i - q * Pfl) if q == r else self.ex_full.recv_index(
                    r, q, i - q * Pfl)
                pt_src[r, ps - r * Pcl] = src
            else:
                src = (i - q * Pfl) if q == r else self.ex_pool.recv_index(
                    r, q, i - q * Pfl)
                child_src[r, ps - r * Pcl, o] = src
        self._child_src = jnp.asarray(child_src)
        self._pt_src = jnp.asarray(pt_src)

        # ---- prolongation: parent patches -> child shards -----------------
        sends_par: Dict[Tuple[int, int], List[int]] = {}
        for i, ps, o, pt in child_info:
            q, r = int(cshard[ps]), int(fshard[i])
            if q != r:
                lst = sends_par.setdefault((q, r), [])
                if (ps - q * Pcl) not in lst:
                    lst.append(ps - q * Pcl)
        for v in sends_par.values():
            v.sort()
        self.ex_par = Exchange(ndev, Pcl, sends_par)
        self.comm_rows += self.ex_par.comm_rows

        # per-orthant groups with uniform counts across shards (+ passthrough)
        groups: Dict[int, List[List[Tuple[int, int]]]] = {
            o: [[] for _ in range(ndev)] for o in range(1 << D)
        }
        ptg: List[List[Tuple[int, int]]] = [[] for _ in range(ndev)]
        for i, ps, o, pt in child_info:
            q, r = int(cshard[ps]), int(fshard[i])
            src = (ps - q * Pcl) if q == r else self.ex_par.recv_index(
                r, q, ps - q * Pcl)
            if pt:
                ptg[r].append((src, i - r * Pfl))
            else:
                groups[o][r].append((src, i - r * Pfl))
        self._pgroups = []  # (orthant or None, SRC [ndev, G], TGTpos)
        stacked_len = 0
        entries = [(o, groups[o]) for o in range(1 << D)] + [(None, ptg)]
        seg_meta = []
        for o, per in entries:
            G = max(len(x) for x in per)
            if G == 0:
                continue
            src = np.full((ndev, G), self.ex_par.buf_rows, dtype=np.int32)
            tgt = np.full((ndev, G), -1, dtype=np.int32)
            for r in range(ndev):
                for j, (s_, f_) in enumerate(per[r]):
                    src[r, j] = s_
                    tgt[r, j] = f_
            seg_meta.append((o, jnp.asarray(src), tgt, stacked_len, G))
            stacked_len += G
        # inverse routing: fine local slot -> stacked row (pad -> stacked_len)
        inv = np.full((ndev, Pfl), stacked_len, dtype=np.int32)
        for o, src_j, tgt, base, G in seg_meta:
            for r in range(ndev):
                for j in range(G):
                    if tgt[r, j] >= 0:
                        inv[r, tgt[r, j]] = base + j
        self._pseg = [(o, src_j, G) for (o, src_j, tgt, base, G) in seg_meta]
        self._pinv = jnp.asarray(inv)
        # f32 fast path: pooled-child placement in Kronecker form (flat
        # [R, (n/2)^D] rows @ [(n/2)^D, n^D]); prolongation reuses the
        # wrapped Transfer's per-orthant Kronecker matrices
        self._Sp = None
        if getattr(transfer, "_use_kron", False):
            emats = [_placement_matrix(n, b) for b in range(2)]
            self._Sp = []
            for o in range(1 << D):
                k = np.kron(emats[(o >> 1) & 1], emats[o & 1]).T
                if D == 2:
                    self._Sp.append(jnp.asarray(k, dtype=jnp.float32))
                else:
                    self._Sp.append((
                        jnp.asarray(k, dtype=jnp.float32),
                        jnp.asarray(emats[(o >> 2) & 1], dtype=jnp.float32),
                    ))
        self._jit = {}

    def _place_o(self, rows: jnp.ndarray, o: int) -> jnp.ndarray:
        """Place pooled-child flat rows ``[R, (n/2)^D]`` into the
        orthant-``o`` block of flat parent rows ``[R, n^D]``."""
        D, n = self.D, self.n
        hp = jax.lax.Precision.HIGHEST
        if self._Sp is not None:
            if D == 2:
                return jnp.dot(rows, self._Sp[o].astype(rows.dtype),
                               precision=hp)
            Wyx, Ez = self._Sp[o]
            R = rows.shape[0]
            x3 = rows.reshape(R, n // 2, (n // 2) ** 2)
            y = jnp.einsum("pwl,zw->pzl", x3, Ez.astype(rows.dtype),
                           precision=hp)
            y = jnp.matmul(y, Wyx.astype(rows.dtype), precision=hp)
            return y.reshape(R, -1)
        emats = [jnp.asarray(_placement_matrix(n, b)) for b in range(2)]
        block = rows.reshape((-1,) + (n // 2,) * D)
        for a in range(D):
            E = emats[(o >> a) & 1].astype(block.dtype)
            block = _axis_matmul(E, block, 1 + (D - 1 - a))
        return block.reshape(rows.shape[0], -1)

    def _smap(self, name, fn, nargs):
        if name not in self._jit:
            self._jit[name] = jax.jit(
                shard_map(fn, self.mesh, in_specs=(P("p"),) * nargs,
                          out_specs=P("p"))
            )
        return self._jit[name]

    def restrict(self, fine_u: jnp.ndarray) -> jnp.ndarray:
        D, n = self.D, self.n
        cells = n**D
        hc = (n // 2) ** D

        def f(u_loc):
            me = jax.lax.axis_index("p")
            # pool children locally before sending (surface-optimal comm:
            # (n/2)^D values per cross-shard child); all buffers and
            # gathers are flat rank-2 rows
            shape = [u_loc.shape[0]]
            for _ in range(D):
                shape += [n // 2, 2]
            pooled = u_loc.reshape(shape).mean(
                axis=tuple(range(2, 2 * D + 2, 2)))
            pbuf = self.ex_pool.run(pooled.reshape(-1, hc), me)
            fbuf = self.ex_full.run(u_loc.reshape(-1, cells), me)
            assembled = None
            for o in range(1 << D):
                block = self._place_o(pbuf[self._child_src[me][:, o]], o)
                assembled = block if assembled is None else assembled + block
            out = assembled + fbuf[self._pt_src[me]]
            return out.reshape((-1,) + (n,) * D)

        return self._smap("restrict", f, 1)(fine_u)

    def prolong_add(self, coarse_u: jnp.ndarray, fine_u: jnp.ndarray) -> jnp.ndarray:
        D, n = self.D, self.n
        cells = n**D
        t = self.t

        def f(uc_loc, uf_loc):
            me = jax.lax.axis_index("p")
            buf = self.ex_par.run(uc_loc.reshape(-1, cells), me)
            mats = t._wlin if self.prolong_mode == "linear" else t._wconst
            parts = []
            for o, src_j, G in self._pseg:
                rows = buf[src_j[me]]  # [G, n^D] flat parent patches
                if o is None:
                    parts.append(rows)  # pass-through copy
                else:
                    parts.append(t._orthant_apply(
                        rows, o,
                        t._Wp if getattr(t, "_use_kron", False) else None,
                        mats,
                    ))
            if not parts:
                return uf_loc
            stacked = (jnp.concatenate(parts, axis=0)
                       if len(parts) > 1 else parts[0])
            zrow = jnp.zeros((1, cells), dtype=stacked.dtype)
            stacked_pad = jnp.concatenate([stacked, zrow], axis=0)
            return uf_loc + stacked_pad[self._pinv[me]].reshape(uf_loc.shape)

        return self._smap("prolong", f, 2)(coarse_u, fine_u)


class HaloApply:
    """Back-compat wrapper: cut-face sharded composite-operator apply."""

    def __init__(self, level: Level, mesh: Mesh):
        self.sharded = ShardedLevel(level, mesh)
        self.level = level
        self.mesh = mesh

    def __call__(self, u: jnp.ndarray) -> jnp.ndarray:
        return self.sharded.apply(u)
