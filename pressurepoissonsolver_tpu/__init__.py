"""pressurepoissonsolver_tpu — a JAX framework for solving Poisson's
equation on adaptively refined, block-structured Cartesian grids.

A from-scratch JAX/XLA re-design of the capabilities of
GEM3D/pressurePoissonSolver ("ThunderEgg"): fixed-size cell-centered patches
on quadtrees (2D) / octrees (3D) with 2:1 balance, fast DST/DCT patch
solvers expressed as batched matmuls, FAC geometric multigrid, a
Schur-complement interface path, and BiCGStab/CG Krylov solvers — all
batched over a leading patch axis and shardable over a `jax.sharding.Mesh`.

The numerical contract (stencils, interface interpolation weights,
transform tables, multigrid transfer operators) matches the reference
semantics documented in SURVEY.md; the implementation is idiomatic
JAX: static shapes, precomputed int32 index tables instead of pointer
graphs, scatter/gather + `psum` instead of MPI/VecScatter.

Double precision is required to reach the reference's 1e-10 relative
residual targets, so importing this package enables x64 mode in JAX.
The multigrid preconditioner can optionally run in f32 (mixed
precision) — see `solver.SolveOptions`.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

#: the checkout root (the directory that holds this package)
_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=None):
    """The persistent compilation cache directory this package uses.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    returned as is (the package then sets nothing).  Otherwise the cache
    lives at the fixed path ``<checkout>/.jax_cache`` — a fixed path, so
    that repeated processes hit it.  ``PPS_NO_COMPILE_CACHE=1`` turns the
    package's cache off (``None``); the CPU test suite does that."""
    environ = _os.environ if environ is None else environ
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return environ["JAX_COMPILATION_CACHE_DIR"]
    if environ.get("PPS_NO_COMPILE_CACHE") == "1":
        return None
    return _os.path.join(_ROOT, ".jax_cache")


# The unrolled multigrid cycle takes a while to compile; cache it across
# processes.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = compile_cache_dir()
    if _cache_dir is not None:
        _jax.config.update("jax_compilation_cache_dir", _cache_dir)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from . import geometry  # noqa: E402
from . import domain  # noqa: E402

__version__ = "0.1.0"
