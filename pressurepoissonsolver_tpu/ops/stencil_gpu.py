"""Fused 2D ghost-closure star stencil for NVIDIA GPUs (Pallas, Triton route).

Computes exactly what ``level_ops._star_stencil`` computes for ``D == 2``:

    out = (lo_x - 2u + hi_x) / h_x^2 + (lo_y - 2u + hi_y) / h_y^2

where a neighbour outside the patch is the ghost ``c * u_b + 2 * gf``.
One program handles ``rows`` rows of one patch on the flat ``[P * n * n]``
field: the four neighbours are contiguous masked loads at offsets ±1 and
±n of the program's own cells (they hit the cache the centre load just
filled), the ghost terms come from contiguous loads of the face traces
broadcast over the tile, and the per-patch coefficients are scalar loads.

``Level.apply`` on a GPU builds the face terms with XLA and calls this
kernel in place of XLA's stencil fusion: on an H100 that apply took
0.496 ms against XLA's 0.595 ms at 68.7M DOF, and the 4.3M-DOF mixed-
precision solve 0.0164 s against 0.0188 s (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def supported(D: int, n: int, dtype) -> bool:
    """Whether the kernel covers this level: 2D, f32, power-of-two n."""
    return (
        D == 2
        and jnp.dtype(dtype) == jnp.float32
        and n >= 2
        and n & (n - 1) == 0
    )


def _kernel(u_ref, gf_ref, coef_ref, h2_ref, o_ref, *, n, rows, base):
    # this program: ``rows`` rows of patch ``p`` (from row ``k0`` of the
    # patch) on the flat field, which starts at offset ``base`` of ``u_ref``
    size = rows * n
    pid = pl.program_id(0)
    p = pid // (n // rows)
    k0 = (pid % (n // rows)) * rows
    e0 = pid * size
    e = jnp.arange(size, dtype=jnp.int32)
    col = e % n
    k = k0 + e // n
    u = plgpu.load(u_ref.at[pl.ds(base + e0, size)])

    def shifted(offset, inside):
        return plgpu.load(
            u_ref.at[pl.ds(base + e0 + offset, size)], mask=inside, other=0.0
        )

    def spread(v, axis):
        # a face vector along ``axis`` of the (rows, n) tile, as a flat tile
        shape = (rows, n)
        v = v[:, None] if axis == 0 else v[None, :]
        return jnp.broadcast_to(v, shape).reshape(size)

    def face(side, start, length):
        return plgpu.load(
            gf_ref.at[pl.ds(p * 4 * n + side * n + start, length)]
        )

    coef = [plgpu.load(coef_ref.at[p * 4 + s]) for s in range(4)]
    h2x = plgpu.load(h2_ref.at[p * 2])
    h2y = plgpu.load(h2_ref.at[p * 2 + 1])
    x_lo, x_hi = col == 0, col == n - 1
    y_lo, y_hi = k == 0, k == n - 1
    left = jnp.where(x_lo, coef[0] * u + 2.0 * spread(face(0, k0, rows), 0),
                     shifted(-1, ~x_lo))
    right = jnp.where(x_hi, coef[1] * u + 2.0 * spread(face(1, k0, rows), 0),
                      shifted(1, ~x_hi))
    down = jnp.where(y_lo, coef[2] * u + 2.0 * spread(face(2, 0, n), 1),
                     shifted(-n, ~y_lo))
    up = jnp.where(y_hi, coef[3] * u + 2.0 * spread(face(3, 0, n), 1),
                   shifted(n, ~y_hi))
    out = (left - 2.0 * u + right) * h2x + (down - 2.0 * u + up) * h2y
    plgpu.store(o_ref.at[pl.ds(e0, size)], out)


@functools.partial(
    jax.jit,
    static_argnames=("rows", "interpret"),
)
def star_stencil_2d(u, gf, ghost_coef, h2inv, *, rows: int = 16,
                    interpret=None):
    """``_star_stencil(u, gf, ghost_coef, h2inv, 2, n)`` for ``u [P, n, n]``,
    ``gf [P, 4, n]``, ``ghost_coef [P, 4]``, ``h2inv [P, 2]``: one program
    per ``rows`` rows of a patch (``rows`` a power of two dividing ``n``;
    16 rows and 4 warps measured fastest at n=64 on an H100).
    ``interpret=None`` compiles for the GPU on a GPU backend and runs the
    Pallas interpreter elsewhere.

    The neighbour loads of the first and last programs start one row
    outside the field (masked lanes, never read on the GPU).  The
    interpreter clamps such slices instead of masking them, so in
    interpret mode the field is padded by one row on each side."""
    if interpret is None:
        interpret = jax.default_backend() != "gpu"
    P, n, _ = u.shape
    rows = min(rows, n)
    total = P * n * n
    if rows & (rows - 1) or n % rows or total + 2 * n >= 2**31:
        raise ValueError(f"rows={rows} must be a power of two dividing n={n}, "
                         "and the field under 2**31 cells")
    dt = u.dtype
    flat = u.reshape(total)
    base = 0
    if interpret:
        flat, base = jnp.pad(flat, (n, n)), n
    args = [
        flat,
        gf.astype(dt).reshape(-1),
        ghost_coef.astype(dt).reshape(-1),
        h2inv.astype(dt).reshape(-1),
    ]
    out = pl.pallas_call(
        functools.partial(_kernel, n=n, rows=rows, base=base),
        out_shape=jax.ShapeDtypeStruct((total,), dt),
        grid=(total // (rows * n),),
        in_specs=[pl.BlockSpec(x.shape, lambda i: (0,)) for x in args],
        out_specs=pl.BlockSpec((total,), lambda i: (0,)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="star_stencil_2d",
    )(*args)
    return out.reshape(u.shape)
