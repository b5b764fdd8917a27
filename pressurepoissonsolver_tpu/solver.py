"""High-level solve driver: GMG-preconditioned BiCGStab on the composite
operator, plus the Schur-complement interface path.

This is the equivalent of the reference ``steady`` apps' solve
section (``apps/2d/steady.cpp:338-640``, ``apps/3d/steady.cpp:296-595``):

* ``solve``: outer BiCGStab on ``A u = f`` with a GMG V(1,1)-cycle
  preconditioner (reference ``--prec GMG --solver thunderegg``).
* ``solve_schur``: eliminate patch interiors, solve the interface system
  ``(I - S) gamma = interp(solve(f, 0))`` with BiCGStab, then recover
  ``u`` by one more round of patch solves (reference ``--schur``).

The Neumann nullspace is handled as in the apps: shift ``f`` to zero mean
before solving and compare solutions modulo a constant
(``apps/3d/steady.cpp:330-334, 539-549``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .domain import DomainHierarchy
from .geometry import Tree
from .gmg import CycleOpts, GMGCycle, build_gmg
from .krylov import KrylovResult, bicgstab
from .ops.level_ops import Level
from .problems import Problem, get_problem, init_problem


@dataclass
class SolveOptions:
    tol: float = 1e-12
    max_iter: int = 1000
    gmg: CycleOpts = field(default_factory=CycleOpts)
    precondition: bool = True
    # dtype of the preconditioner levels; float32 gives mixed precision
    precond_dtype: object = jnp.float64
    dtype: object = jnp.float64
    krylov: str = "bicgstab"  # "bicgstab" | "cg" | "gmres"
    # inner Krylov method of the mixed-precision IR solve.  "cg" exploits
    # the exact D-self-adjointness of the composite operator + V-cycle
    # (see krylov.cg) at half the per-iteration cost of BiCGStab, but in
    # f32 later refinement rounds solve against noise-floor residuals,
    # where reduced-precision spectral transforms make M slightly
    # non-self-adjoint and the CG recurrence can stall.  BiCGStab is the
    # robust default; CG remains right for the full-f64 path.
    inner_krylov: str = "bicgstab"  # "bicgstab" | "cg" | "richardson"
    preconditioner: str = "gmg"  # "gmg" | "schwarz" | "none"
    patch_solver: str = "dft"  # "dft" (spectral) | "bcgs" (iterative)
    # multi-chip communication schedule (only with a mesh):
    # "halo" — explicit cut-face ppermute exchange
    # (parallel/halo.ShardedLevel); "pjit" — XLA partitions the global
    # gathers (kept for comparison/debugging); "auto" — halo whenever a
    # mesh is present
    comm: str = "auto"
    # interface interpolation at refinement boundaries: "bilinear"
    # (reference BilinearInterpolator/TriLinInterp) or "quadratic"
    # (2D only; the reference's higher-order StencilHelper2d closures)
    iface_scheme: str = "bilinear"


class PoissonSolver:
    """Composite-grid Poisson solver over a domain hierarchy.

    Pass ``mesh`` (a 1D ``jax.sharding.Mesh`` with axis ``"p"``; see
    ``parallel.sharding.make_mesh``) to run every level, transfer, and
    Krylov iteration patch-sharded over the device mesh — the production
    multi-chip mode.  The hierarchy must have been built with
    ``DomainHierarchy(..., num_shards=mesh.size)`` so patch counts divide
    the mesh and slots follow the Morton partition.
    """

    def __init__(
        self,
        hierarchy: DomainHierarchy,
        options: Optional[SolveOptions] = None,
        mesh=None,
    ):
        self.hierarchy = hierarchy
        self.opts = options or SolveOptions()
        self.mesh = mesh
        if self.opts.comm == "auto":
            self.opts.comm = "halo"
        if self.opts.iface_scheme != "bilinear":
            # the higher-order closures are not self-adjoint in the volume
            # inner product — fall back to BiCGStab
            if self.opts.krylov == "cg":
                self.opts.krylov = "bicgstab"
            if self.opts.inner_krylov == "cg":
                self.opts.inner_krylov = "bicgstab"
        self.fine_level = Level(
            hierarchy.finest,
            dtype=self.opts.dtype,
            patch_solver=self.opts.patch_solver,
            iface_scheme=self.opts.iface_scheme,
        )
        if self.opts.preconditioner != "gmg":
            self.opts.precondition = False
        if self.opts.precondition:
            if self.opts.precond_dtype == self.opts.dtype:
                # reuse the fine level object for the finest GMG level
                self.gmg = build_gmg(
                    hierarchy, self.opts.gmg, dtype=self.opts.dtype, mesh=mesh
                )
                self.gmg.levels[0] = self.fine_level
                if self.gmg.transfers:
                    self.gmg.transfers[0].fine = self.fine_level
            else:
                self.gmg = build_gmg(
                    hierarchy, self.opts.gmg, dtype=self.opts.precond_dtype, mesh=mesh
                )
        else:
            self.gmg = None
        if mesh is not None:
            self.fine_level.set_mesh(mesh)
        # cut-face halo mode: wrap every level/transfer in the explicit
        # ppermute exchange engine (the op-level numerics are identical)
        self._op = self.fine_level
        if mesh is not None and self.opts.comm == "halo":
            from .parallel.halo import ShardedLevel, ShardedTransfer

            self._op = ShardedLevel(self.fine_level, mesh)
            if self.gmg is not None:
                self._wrap_halo(self.gmg)
        self._solve_jit = None
        self._apply_jit = None
        self._fine_low = None
        self._inner_jit = None
        self._inner_jit_key = None
        self._schur_jit = None
        self._schur_jit_key = None

    def _wrap_halo(self, gmg) -> None:
        """Wrap a GMG cycle's levels/transfers in the cut-face halo engine
        (``self._op`` must already be the wrapped finest level)."""
        from .parallel.halo import ShardedLevel, ShardedTransfer

        wrapped = [
            self._op if l is self.fine_level else ShardedLevel(l, self.mesh)
            for l in gmg.levels
        ]
        gmg.transfers = [
            ShardedTransfer(tr, wrapped[k], wrapped[k + 1])
            for k, tr in enumerate(gmg.transfers)
        ]
        gmg.levels = wrapped
        # FAC active-set smoothing: per-shard subset compute
        # instead of the masked-full-sweep fallback
        gmg.attach_sharded_active()

    def _device_put(self, f: jnp.ndarray) -> jnp.ndarray:
        """Place a patch array according to the solver's mesh (no-op when
        single-device)."""
        if self.mesh is None:
            return f
        return jax.device_put(f, self.fine_level._psh)

    def _volume_weight(self, dtype) -> jnp.ndarray:
        """Per-cell volume weights [P, 1, ..] — the inner product in which
        the composite operator and the V-cycle are exactly self-adjoint.

        Normalized to mean 1: CG is invariant to a scalar rescaling of the
        inner product, and raw cell volumes (~h^D ~ 1e-6) make f32 weighted
        dots underflow as the residual shrinks."""
        pl = self.hierarchy.finest
        w = np.prod(pl.spacings, axis=1)
        w = w / w.mean()
        return jnp.asarray(
            w.reshape((pl.num_patches,) + (1,) * pl.D), dtype=dtype
        )

    # -- operators ----------------------------------------------------------

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        if self._apply_jit is None:
            self._apply_jit = jax.jit(self._op.apply)
        return self._apply_jit(u)

    def _preconditioner(self) -> Optional[Callable]:
        if self.opts.preconditioner == "schwarz":
            from .precond import schwarz

            return schwarz(self.fine_level)
        if self.gmg is None:
            return None
        pdtype = self.opts.precond_dtype
        dtype = self.opts.dtype

        def M(r):
            return self.gmg.apply(r.astype(pdtype)).astype(dtype)

        return M

    # -- solves -------------------------------------------------------------

    def solve(
        self,
        f: jnp.ndarray,
        tol: Optional[float] = None,
        max_iter: Optional[int] = None,
    ) -> KrylovResult:
        """GMG-preconditioned BiCGStab on ``A u = f``."""
        tol = self.opts.tol if tol is None else tol
        max_iter = self.opts.max_iter if max_iter is None else max_iter
        if self._solve_jit is None:
            from .krylov import cg, gmres

            A = self._op.apply
            M = self._preconditioner()
            if self.opts.krylov == "cg":
                w = self._volume_weight(self.opts.dtype)

                def run(b, tol_, max_iter_):
                    return cg(A, b, M=M, tol=tol_, max_iter=max_iter_, weight=w)

            else:
                method = gmres if self.opts.krylov == "gmres" else bicgstab

                def run(b, tol_, max_iter_):
                    return method(A, b, M=M, tol=tol_, max_iter=max_iter_)

            self._solve_jit = jax.jit(run, static_argnums=(2,))
        return self._solve_jit(
            self._device_put(jnp.asarray(f, dtype=self.opts.dtype)), tol, max_iter
        )

    def solve_monitored(
        self,
        f: jnp.ndarray,
        tol: Optional[float] = None,
        max_iter: int = 200,
        schur: bool = False,
        schur_preconditioner: Optional[str] = None,
    ):
        """Solve with a per-iteration residual-norm history (the
        observability hook behind the CLI ``--monitor`` flag; the reference
        BiCGStab reports only the final count, ``BiCGStab.h:70-105``).

        Returns ``(u, KrylovResult, history)`` where ``history[k]`` is the
        *relative* residual norm after iteration ``k`` (entries past
        convergence repeat the final value).  Honors ``opts.krylov``
        (bicgstab / cg / gmres; for GMRES the in-cycle entries are the
        running Givens estimates, corrected to the true residual at each
        restart boundary).  Only run when asked: the fixed-trip monitored
        loops always execute ``max_iter`` iterations (bicgstab/cg).
        """
        from .krylov import cg_history, gmres, residual_history

        method = self.opts.krylov
        tol = self.opts.tol if tol is None else tol
        key = (tol, max_iter, schur, schur_preconditioner, method)
        if getattr(self, "_monitor_jit_key", None) == key:
            run = self._monitor_run
            f = self._device_put(jnp.asarray(f, dtype=self.opts.dtype))
            u, res, hist = run(f)
            r0 = np.asarray(res.r0_norm)
            rel = np.asarray(hist) / (r0 if r0 > 0 else 1.0)
            return u, res, rel[: int(res.iterations) + 1]
        lvl = self._op
        M = self._preconditioner() if not schur else None
        if schur:
            if schur_preconditioner == "cheb":
                from .precond import poly_cheb

                M = poly_cheb(lvl)
            elif schur_preconditioner == "blockjacobi":
                from .matrix import schur_block_jacobi

                M = schur_block_jacobi(self.fine_level, engine=lvl)
            elif schur_preconditioner == "gmg":
                M = self.schur_gmg_preconditioner()

            def hist_solve(A, rhs, M):
                if method == "gmres":
                    return gmres(A, rhs, M=M, tol=tol, max_iter=max_iter,
                                 history=True)
                if method == "cg":
                    return cg_history(A, rhs, M=M, tol=tol, max_iter=max_iter)
                return residual_history(A, rhs, M=M, tol=tol,
                                        max_iter=max_iter)

            @jax.jit
            def run(b):
                def A_schur(g):
                    return g - lvl.schur_S(g)

                gamma0 = lvl.gamma_zeros(b.dtype)
                rhs = lvl.interpolate(lvl.patch_solve(b, gamma0))
                res, hist = hist_solve(A_schur, rhs, M)
                u = lvl.patch_solve(b, res.x)
                return u, res, hist

        else:
            w = (
                self._volume_weight(self.opts.dtype)
                if method == "cg" else None
            )

            @jax.jit
            def run(b):
                if method == "gmres":
                    res, hist = gmres(lvl.apply, b, M=M, tol=tol,
                                      max_iter=max_iter, history=True)
                elif method == "cg":
                    res, hist = cg_history(lvl.apply, b, M=M, tol=tol,
                                           max_iter=max_iter, weight=w)
                else:
                    res, hist = residual_history(
                        lvl.apply, b, M=M, tol=tol, max_iter=max_iter
                    )
                return res.x, res, hist

        self._monitor_run = run
        self._monitor_jit_key = key
        f = self._device_put(jnp.asarray(f, dtype=self.opts.dtype))
        u, res, hist = run(f)
        r0 = np.asarray(res.r0_norm)
        rel = np.asarray(hist) / (r0 if r0 > 0 else 1.0)
        return u, res, rel[: int(res.iterations) + 1]

    def solve_refined(
        self,
        f: jnp.ndarray,
        tol: Optional[float] = None,
        inner_tol: float = 1e-5,
        max_outer: int = 12,
        inner_max_iter: int = 60,
        sync: bool = True,
    ):
        """Mixed-precision iterative refinement: inner GMG-BiCGStab solves
        in the preconditioner dtype (f32), residual updates in f64.

        Classic IR reaches full f64 accuracy while doing nearly all Krylov
        work in low precision, which moves half the bytes of the
        reference's all-f64 solves.  The entire outer loop (residual
        update, convergence/stagnation/breakdown logic, inner Krylov solve)
        runs inside one jitted ``lax.while_loop`` — a complete solve is a
        single device dispatch with no host round-trips.

        Returns ``(u, info dict)`` with honest iteration counts:
        ``outer_iterations`` (refinement rounds) and ``inner_iterations``
        (total BiCGStab iterations across all rounds).
        """
        tol = self.opts.tol if tol is None else tol
        pdtype = self.opts.precond_dtype
        if self._fine_low is None:
            if self.gmg is not None and self.gmg.levels[0].dtype == pdtype:
                self._fine_low = self.gmg.levels[0]
            else:
                self._fine_low = Level(self.hierarchy.finest, dtype=pdtype)
                if self.mesh is not None:
                    self._fine_low.set_mesh(self.mesh)
                if self.mesh is not None and self.opts.comm == "halo":
                    from .parallel.halo import ShardedLevel

                    self._fine_low = ShardedLevel(self._fine_low, self.mesh)
        low = self._fine_low
        key = (max_outer, inner_max_iter, self.opts.inner_krylov)
        if self._inner_jit_key != key:
            from .krylov import cg, richardson

            M = (lambda r: self.gmg.apply(r)) if self.gmg is not None else None
            apply64 = self._op.apply
            inner_name = self.opts.inner_krylov
            if inner_name == "cg":
                w_in = self._volume_weight(pdtype)

                def inner_solve(r32, tol_):
                    return cg(low.apply, r32, M=M, tol=tol_,
                              max_iter=inner_max_iter, weight=w_in)

            elif inner_name == "richardson":

                def inner_solve(r32, tol_):
                    return richardson(low.apply, r32, M=M, tol=tol_,
                                      max_iter=inner_max_iter)

            else:

                def inner_solve(r32, tol_):
                    return bicgstab(low.apply, r32, M=M, tol=tol_,
                                    max_iter=inner_max_iter)

            @jax.jit
            def run(f, tol_, inner_tol_):
                fnorm = jnp.linalg.norm(f.ravel())
                fnorm = jnp.where(fnorm > 0, fnorm, 1.0)
                u0 = jnp.zeros_like(f)
                # per-outer-round relative-residual history (--monitor ir)
                hist0 = jnp.ones(max_outer + 1, dtype=f.dtype)
                # state: u, r, best_u, best_rel, rel, k, inner_total,
                #        stop, hist
                state = (
                    u0,
                    f,
                    u0,
                    jnp.asarray(jnp.inf, f.dtype),
                    jnp.asarray(1.0, f.dtype),
                    jnp.int32(0),
                    jnp.int32(0),
                    jnp.bool_(False),
                    hist0,
                )

                def cond(st):
                    return jnp.logical_not(st[7])

                def body(st):
                    u, r, best_u, best_rel, rel, k, inner_total, _, hist = st
                    e_res = inner_solve(r.astype(pdtype), inner_tol_)
                    e = jnp.where(jnp.isfinite(e_res.x), e_res.x, 0.0)
                    u_new = u + e.astype(f.dtype)
                    r_new = f - apply64(u_new)
                    rel_new = jnp.linalg.norm(r_new.ravel()) / fnorm
                    breakdown = jnp.logical_not(jnp.isfinite(rel_new))
                    improved = rel_new < best_rel
                    best_u_new = jnp.where(improved, u_new, best_u)
                    best_rel_new = jnp.where(improved, rel_new, best_rel)
                    k = k + 1
                    stagnated = jnp.logical_and(
                        k > 3,
                        jnp.logical_and(rel_new > 0.5 * best_rel, rel_new > 10 * tol_),
                    )
                    stop = (
                        breakdown
                        | (rel_new <= tol_)
                        | stagnated
                        | (k >= max_outer)
                    )
                    # on breakdown, fall back to the best iterate so far
                    u_out = jnp.where(breakdown, best_u, u_new)
                    rel_out = jnp.where(breakdown, best_rel, rel_new)
                    hist = hist.at[k].set(rel_out)
                    return (
                        u_out,
                        r_new,
                        best_u_new,
                        best_rel_new,
                        rel_out,
                        k,
                        inner_total + e_res.iterations,
                        stop,
                        hist,
                    )

                (u, r, best_u, best_rel, rel, k, inner_total, _, hist) = (
                    jax.lax.while_loop(cond, body, state)
                )
                return u, rel, k, inner_total, hist

            self._inner_jit = run
            self._inner_jit_key = key

        f = self._device_put(jnp.asarray(f, dtype=self.opts.dtype))
        u, rel, k, inner_total, hist = self._inner_jit(
            f, jnp.asarray(tol, f.dtype), jnp.asarray(inner_tol, pdtype)
        )
        if not sync:
            # leave the diagnostics on device: each host fetch is a
            # device-to-host round trip that would otherwise sit inside a
            # timed solve
            return u, {
                "outer_iterations": k,
                "inner_iterations": inner_total,
                "residual": rel,
                "outer_history": hist,
            }
        info = {
            "outer_iterations": int(k),
            "inner_iterations": int(inner_total),
            "residual": float(rel),
            "outer_history": np.asarray(hist)[: int(k) + 1],
        }
        return u, info

    def schur_gmg_preconditioner(self) -> Callable:
        """AMG-strength interface preconditioner from the composite GMG.

        Woodbury: with ``A = K + G Γ`` (composite operator = block patch
        stencil ``K`` plus ghost injection ``G`` of the interpolated traces
        ``Γ``) the interface system matrix factors *exactly* as

            ``(I - S)⁻¹ = (I + Γ K⁻¹ G)⁻¹ = I - Γ A⁻¹ G``.

        Replacing ``A⁻¹`` by one GMG V-cycle ``M_A`` gives the
        preconditioned operator ``I + Γ (I - M_A A) K⁻¹ G``, whose
        deviation from the identity is bounded by the (mesh-independent)
        V-cycle contraction — so Schur iterations become mesh-independent,
        the quality the reference buys with hypre/BoomerAMG on the
        assembled interface matrix (BASELINE.md: 15-19 iterations from
        2.1M to 136M DOF; the dead in-tree sketch of a GMG interface
        preconditioner is ``GMG/Helper2dSchur.cpp:36-155``).

        One application costs one ghost injection (pad-spread fold), one
        V-cycle, and one trace interpolation.
        """
        if self.gmg is None:
            self.gmg = build_gmg(
                self.hierarchy, self.opts.gmg, dtype=self.opts.precond_dtype,
                mesh=self.mesh,
            )
            if self.mesh is not None and self.opts.comm == "halo":
                self._wrap_halo(self.gmg)
        lvl = self._op
        gmg = self.gmg
        pdtype = self.opts.precond_dtype

        def M(rho):
            zf = lvl.zeros().astype(rho.dtype)
            g = lvl.fold_gamma(zf, rho)  # = -G rho
            e = gmg.apply(g.astype(pdtype)).astype(rho.dtype)
            return rho + lvl.interpolate(e)  # = rho - Γ M_A G rho

        return M

    def solve_schur(
        self,
        f: jnp.ndarray,
        tol: Optional[float] = None,
        max_iter: Optional[int] = None,
        preconditioner: Optional[str] = None,  # None|"cheb"|"blockjacobi"|"gmg"
    ):
        """Schur-complement path (reference ``--schur``).

        The interface condition is flux continuity across each interface:
        ``gamma = interp(solve(f, gamma))`` (see ``SchurHelper.h:281-299``
        and the probed matrix diagonal in ``SchurMatrixHelper2d.cpp:170-184``),
        i.e. the linear system ``(I - S) gamma = interp(solve(f, 0))`` with
        ``S = interp(solve(0, .))``.  Returns ``(u, KrylovResult)``.

        The Krylov method follows ``opts.krylov``; ``gmres`` here is the
        BASELINE "matrix-free GMRES on the Schur interface system"
        configuration.
        """
        tol = self.opts.tol if tol is None else tol
        max_iter = self.opts.max_iter if max_iter is None else max_iter
        # the sharded engines (pjit-constrained Level / halo ShardedLevel)
        # run the Schur path too: SchurHelper is the reference's central
        # *distributed* object (SchurHelper.h:215-331)
        lvl = self._op

        def A_schur(gamma):
            return gamma - lvl.schur_S(gamma)

        key = (preconditioner, tol, max_iter)
        if self._schur_jit_key != key:
            M = None
            if preconditioner == "cheb":
                from .precond import poly_cheb

                M = poly_cheb(lvl)
            elif preconditioner == "blockjacobi":
                from .matrix import schur_block_jacobi

                M = schur_block_jacobi(self.fine_level, engine=lvl)
            elif preconditioner == "gmg":
                M = self.schur_gmg_preconditioner()

            from .krylov import gmres

            method = gmres if self.opts.krylov == "gmres" else bicgstab

            @jax.jit
            def run(f):
                gamma0 = lvl.gamma_zeros(f.dtype)
                b = lvl.interpolate(lvl.patch_solve(f, gamma0))
                res = method(A_schur, b, M=M, tol=tol, max_iter=max_iter)
                u = lvl.patch_solve(f, res.x)
                return u, res

            self._schur_jit = run
            self._schur_jit_key = key

        f = self._device_put(jnp.asarray(f, dtype=self.opts.dtype))
        return self._schur_jit(f)

    # -- diagnostics --------------------------------------------------------

    def report(self, u, f, exact, neumann: bool = False) -> dict:
        """Error/residual/conservation block (``apps/2d/steady.cpp:570-606``).

        Sharded levels carry padding slots (isolated dummy patches,
        ``parallel/sharding.pad_level``); ``init_problem`` fills those
        slots with problem data at the dummy coordinates, so every metric
        here masks to the real patches — without the mask the error and
        integral metrics are polluted by the pads (found via the sharded
        all-Neumann Schur tests).
        """
        lvl = self.fine_level
        real = lvl.pl.real_patches
        if real < lvl.P:
            mask = (jnp.arange(lvl.P) < real).reshape(
                (lvl.P,) + (1,) * lvl.D
            )
            u = jnp.where(mask, u, 0.0)
            f = jnp.where(mask, f, 0.0)
            exact = jnp.where(mask, exact, 0.0)
        au = self.apply(u)
        if real < lvl.P:
            au = jnp.where(mask, au, 0.0)
        resid = f - au
        out = {}
        out["residual"] = float(jnp.linalg.norm(resid.ravel()) / jnp.linalg.norm(f.ravel()))
        err = exact - u
        if neumann:
            # compare modulo the constant nullspace: shift the error to zero
            # mean (reference apps/2d/steady.cpp:588-599)
            uavg = lvl.integrate(u) / lvl.volume
            eavg = lvl.integrate(exact) / lvl.volume
            err = err - (eavg - uavg)
            if real < lvl.P:
                err = jnp.where(mask, err, 0.0)
        out["error"] = float(
            jnp.linalg.norm(err.ravel()) / jnp.linalg.norm(exact.ravel())
        )
        out["conservation"] = float(lvl.integrate(au) - lvl.integrate(f))
        return out


def shift_for_neumann(level: Level, f: jnp.ndarray) -> jnp.ndarray:
    """Zero the mean of f (Neumann compatibility, ``steady.cpp:330-334``)."""
    fdiff = level.integrate(f) / level.volume
    return f - fdiff
