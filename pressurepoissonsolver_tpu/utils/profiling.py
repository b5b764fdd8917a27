"""Profiling/tracing: device traces, op timing, and roofline estimates
(the aux 'tracing' subsystem; SURVEY.md §5).

The reference has only the MPI-synchronized section timer; here we add

* ``trace`` / ``annotate`` — ``jax.profiler`` capture for TensorBoard/
  Perfetto inspection of the compiled kernels;
* ``time_op`` — robust wall timing of a jitted callable (warm-up +
  ``block_until_ready``), both dispatch-bound (per call) and in-graph
  (``fori_loop``-chained) variants;
* ``op_report`` — per-core-op timing table of a Level (interpolate /
  stencil / patch solve / smooth / full apply) with bandwidth-roofline
  percentages against the peak table ``DEVICE_PEAKS``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional


@contextlib.contextmanager
def trace(logdir: str = "/tmp/pps_trace"):
    """Capture a device trace around a code block::

        with profiling.trace("/tmp/trace"):
            solver.solve(f).x.block_until_ready()
    """
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace annotation for a region (shows up in the trace viewer)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def time_op(fn: Callable, *args, reps: int = 200, in_graph: bool = False,
            trials: int = 3, hbm_rotate: int = 0):
    """Seconds per call of ``fn(*args)`` after a compile/warm-up call.

    ``in_graph=True`` chains ``reps`` calls inside one jitted loop with a
    *dynamic* trip count and returns ``(t(reps) - t(0)) / reps`` — the
    zero-trip execution of the same program calibrates out the fixed
    per-program cost (dispatch, loop set-up and the final fence), which
    otherwise swamps sub-millisecond ops.  Loop-resident operands that
    fit the device's cache stay there, so the steady-state number is
    cache-optimistic for small fields.  Without ``in_graph`` each rep is
    a separate dispatch.

    ``hbm_rotate=B`` (with ``in_graph``) is the memory-forced variant:
    the loop carries ``B`` distinct live copies of the primary operand
    and each iteration consumes the oldest, so with ``B * field_bytes``
    larger than the cache the op's input streams from device memory
    every iteration.  ``op_report`` sizes ``B`` from the device table's
    cache size.
    """
    import jax

    if in_graph:
        import jax.numpy as jnp

        B = max(int(hbm_rotate), 0)
        if B > 1:
            # a stacked ring buffer updated in place: while_loop carries
            # pin each component to a fixed buffer, so rotating a TUPLE
            # of carries copies every buffer per iteration.  Reading slot
            # i%B and writing it back gives a reuse distance of B
            # iterations — with B*field > cache every read streams from
            # HBM, and the dynamic slice/update fuses with the op.
            stack = jnp.stack(
                [args[0] * (1.0 + 1e-7 * i) for i in range(B)]
            )
            jax.block_until_ready(stack)

            @jax.jit
            def loop(st, n):
                def body(i, st):
                    k = jax.lax.rem(i, jnp.asarray(B, i.dtype))
                    x = jax.lax.dynamic_index_in_dim(st, k, keepdims=False)
                    out = fn(x, *args[1:])
                    if out.shape != x.shape:
                        # scalar data dependency only — a mean reduction
                        # here costs a full extra pass over the output
                        out = x + out.ravel()[0] * 1e-30
                    return jax.lax.dynamic_update_index_in_dim(st, out, k, 0)

                return jax.lax.fori_loop(0, n, body, st)

            arg0 = stack
        else:

            @jax.jit
            def loop(x, n):
                def body(i, v):
                    out = fn(v, *args[1:])
                    if out.shape == v.shape:
                        return out
                    # shape-changing op: scalar data dependency so XLA
                    # cannot dead-code-eliminate it (a mean here costs a
                    # full extra pass over the output)
                    return v + out.ravel()[0] * 1e-30

                return jax.lax.fori_loop(0, n, body, x)

            arg0 = args[0]

        jax.block_until_ready(loop(arg0, reps))  # compile + warm
        jax.block_until_ready(loop(arg0, 0))
        best_base = best_full = float("inf")
        for _ in range(trials):
            t0 = time.time()
            jax.block_until_ready(loop(arg0, 0))
            best_base = min(best_base, time.time() - t0)
            t0 = time.time()
            jax.block_until_ready(loop(arg0, reps))
            best_full = min(best_full, time.time() - t0)
        # min each leg separately: min over per-trial deltas is biased by
        # launch-cost jitter (one slow base run makes the delta negative)
        delta = best_full - best_base
        if delta <= 0:
            # noise-dominated: the op is cheaper than launch jitter —
            # flag the measurement instead of reporting an absurd number
            return float("nan")
        return delta / reps

    jfn = jax.jit(fn)
    out = jfn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = jfn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / reps


#: Published peaks by the exact ``device_kind`` JAX reports.  An unknown
#: device is an error, not a default.
DEVICE_PEAKS = {
    # NVIDIA H100 SXM data sheet: 80 GB HBM3 at 3.35 TB/s, 50 MB L2
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "cache_bytes": 50e6},
    # nominal host figures, so the CPU tests can run the same code paths;
    # no CPU number is a device metric
    "cpu": {"hbm_bytes_per_s": 50e9, "cache_bytes": 32e6},
}


def device_peaks(kind: Optional[str] = None) -> Dict[str, float]:
    """Peak figures of device ``kind`` (default: the first JAX device)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no peak figures for device kind {kind!r}; add a row to "
            "utils.profiling.DEVICE_PEAKS"
        ) from None


def _device_bw() -> float:
    return device_peaks()["hbm_bytes_per_s"]


def nvidia_smi() -> str:
    """``name, power.limit`` of each GPU, as nvidia-smi reports them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_info(platform: str = "gpu") -> Dict[str, object]:
    """The device a measurement runs on: platform, ``device_kind`` and
    count as JAX reports them, plus nvidia-smi's name and power limit.
    Raises unless the first JAX device is a ``platform`` device — a
    measurement never falls back to another backend."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != platform:
        raise RuntimeError(
            f"needs a {platform} device; JAX found {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": nvidia_smi() if platform == "gpu" else None,
    }


def op_report(level, reps: int = 20, hbm_force: bool = False) -> Dict[str, dict]:
    """Timing + roofline table of a Level's core ops.

    Roofline bytes are the *algorithmically required* traffic (read the
    input patch field once, write the output once) — intermediate
    materializations count against the achieved fraction, which is the
    point: it measures how far the compiled pipeline is from
    speed-of-light for the op's useful data.

    ``hbm_force=True`` adds a ``<op>_hbm`` row per op timed with a
    rotation set of live input buffers four times larger than the
    device's cache (``time_op(hbm_rotate=...)``), so the primary operand
    streams from device memory each iteration — the counterpart of the
    cache-optimistic steady-state numbers.
    """
    import jax.numpy as jnp
    import numpy as np

    peaks = device_peaks()
    bw = peaks["hbm_bytes_per_s"]
    itemsize = jnp.dtype(level.dtype).itemsize
    cells = level.P * level.pl.cells_per_patch
    field_bytes = cells * itemsize
    rng = np.random.default_rng(0)
    u = jnp.asarray(
        rng.standard_normal((level.P,) + level.pl.ns_shape), dtype=level.dtype
    )
    g = jnp.asarray(
        rng.standard_normal((max(level.num_ifaces, 1), level.m)),
        dtype=level.dtype,
    )
    nnz = (2 * level.D + 1) * cells

    out: Dict[str, dict] = {}

    def add(name, fn, args, bytes_needed, nnz_count=None):
        in_graph = args[0].shape == u.shape
        t = time_op(fn, *args, reps=reps, in_graph=in_graph)
        rec = {
            "ms": round(t * 1e3, 6),
            "roofline_pct": round(100 * bytes_needed / bw / t, 2),
        }
        if nnz_count:
            rec["gnnz_per_s"] = round(nnz_count / t / 1e9, 2)
        out[name] = rec
        if hbm_force and in_graph:
            B = max(3, int(4 * peaks["cache_bytes"] / max(field_bytes, 1)) + 1)
            th = time_op(fn, *args, reps=reps, in_graph=True, hbm_rotate=B)
            out[name + "_hbm"] = {
                "ms": round(th * 1e3, 6),
                "roofline_pct": round(100 * bytes_needed / bw / th, 2),
                "rotation_buffers": B,
            }

    add("interpolate", level.interpolate, (u,), 2 * field_bytes)
    add("apply", level.apply, (u,), 2 * field_bytes, nnz)
    add("patch_solve", lambda x: level.patch_solve(x, g), (u,), 2 * field_bytes)
    add("smooth", lambda x: level.smooth(x, x), (u,), 3 * field_bytes)
    return out
