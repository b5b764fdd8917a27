"""Iterative per-patch solver: batched BiCGStab over all patches at once.

Reference ``PatchSolvers/BiCGStabSolver.h:524-624`` runs a scalar BiCGStab
per patch as a fallback for operators the DST/DCT diagonalization cannot
handle (variable coefficients, Helmholtz with spatially varying shift...).
The batched form runs *all* patches simultaneously: the per-patch
scalars (rho, alpha, omega) become ``[P]`` vectors, and converged patches
are frozen with masks inside one ``lax.while_loop``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def batched_patch_bicgstab(
    op_apply: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    tol: float = 1e-12,
    max_iter: int = 1000,
) -> jnp.ndarray:
    """Solve ``op(u_p) = b_p`` independently for every patch ``p``.

    ``op_apply`` must act patchwise (block-diagonal over the leading axis),
    e.g. the homogeneous patch stencil with fixed interface data folded
    into ``b`` beforehand.
    """
    P = b.shape[0]
    flat = lambda v: v.reshape(P, -1)
    pdot = lambda u, v: jnp.sum(flat(u) * flat(v), axis=1)
    bshape = (P,) + (1,) * (b.ndim - 1)
    bc = lambda s: s.reshape(bshape)

    x = jnp.zeros_like(b)
    r = b - op_apply(x)
    r0n = jnp.sqrt(pdot(r, r))
    safe_r0n = jnp.where(r0n > 0, r0n, 1.0)
    rhat = r
    p = r
    rho = pdot(rhat, r)

    def active(r):
        return jnp.sqrt(pdot(r, r)) / safe_r0n > tol

    def cond(state):
        x, r, p, rho, k = state
        return jnp.logical_and(jnp.any(active(r)), k < max_iter)

    def body(state):
        x, r, p, rho, k = state
        mask = active(r)
        ap = op_apply(p)
        denom = pdot(rhat, ap)
        alpha = jnp.where(denom != 0, rho / jnp.where(denom != 0, denom, 1.0), 0.0)
        s = r - bc(alpha) * ap
        as_ = op_apply(s)
        as2 = pdot(as_, as_)
        omega = jnp.where(as2 != 0, pdot(as_, s) / jnp.where(as2 != 0, as2, 1.0), 0.0)
        x_new = x + bc(alpha) * p + bc(omega) * s
        r_new = r - bc(alpha) * ap - bc(omega) * as_
        rho_new = pdot(r_new, rhat)
        beta = jnp.where(
            (rho != 0) & (omega != 0),
            rho_new * alpha / jnp.where(rho * omega != 0, rho * omega, 1.0),
            0.0,
        )
        p_new = r_new + bc(beta) * (p - bc(omega) * ap)
        # freeze converged patches
        mk = bc(mask.astype(x.dtype))
        x = x + mk * (x_new - x)
        r = r + mk * (r_new - r)
        p = p + mk * (p_new - p)
        rho = jnp.where(mask, rho_new, rho)
        return (x, r, p, rho, k + 1)

    x, r, p, rho, k = jax.lax.while_loop(cond, body, (x, r, p, rho, jnp.int32(0)))
    return x


class BcgsPatchSolver:
    """Drop-in alternative to the spectral patch solve on a Level: solves
    the same per-patch systems iteratively (useful for operators without a
    fast diagonalization)."""

    def __init__(self, level, tol: float = 1e-12, max_iter: int = 1000):
        self.level = level
        self.tol = tol
        self.max_iter = max_iter

    def patch_solve(self, f: jnp.ndarray, gamma: jnp.ndarray) -> jnp.ndarray:
        lvl = self.level
        # fold gamma into the RHS, then solve the homogeneous patch systems
        fc = lvl._fold_gamma_into_rhs(f, gamma)
        zero_gamma = jnp.zeros((lvl.num_ifaces, lvl.m), dtype=f.dtype)

        def op(u):
            return lvl.apply_with_interface(u, zero_gamma)

        return batched_patch_bicgstab(op, fc, tol=self.tol, max_iter=self.max_iter)

    def smooth(self, f: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        return self.patch_solve(f, self.level.interpolate(u))
