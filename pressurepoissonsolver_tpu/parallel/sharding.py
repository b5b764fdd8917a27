"""Multi-chip distribution: patch-axis sharding over a device mesh.

The reference's only distribution axis is the patch set (SPMD domain
decomposition over MPI ranks with Zoltan balancing and VecScatter halo
exchange; SURVEY.md §2.2).  The equivalent implemented here:

* a 1D ``jax.sharding.Mesh`` with axis ``"p"`` (patches);
* every ``[P, ...]`` patch-field array sharded on its leading axis;
* interface (gamma) vectors sharded on the interface axis;
* all gathers/scatter-adds in the level ops use *global* patch indices, so
  under ``jit`` XLA partitions them and inserts the collectives (NCCL over NVLink on
  GPUs) that
  replace the reference's VecScatters — no MPI-style code needed;
* the static block partition of patch slots replaces Zoltan migration
  (patch slots are already ordered by tree id ≈ Morton order, giving the
  same locality the reference gets from hypergraph partitioning).

Padding: patch and interface counts are padded to a multiple of the mesh
size with isolated dummy patches (no neighbors, zero RHS) which stay
identically zero through every linear operation.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..domain import PatchLevel


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1D mesh over the patch axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), ("p",))


def pad_level(pl: PatchLevel, multiple: int) -> PatchLevel:
    """Pad the patch tables with isolated dummy patches so the patch count
    divides the mesh size.  Dummy patches have no neighbors and Dirichlet
    walls; with zero RHS they remain exactly zero under every level op."""
    P_now = pl.num_patches
    pad = (-P_now) % multiple
    if pad == 0:
        return pl
    D, S = pl.D, 2 * pl.D
    half = 1 << (D - 1)

    def cat(a, fill, shape):
        extra = np.full((pad,) + shape, fill, dtype=a.dtype)
        return np.concatenate([a, extra], axis=0)

    max_id = int(pl.ids.max())
    new_ids = np.concatenate(
        [pl.ids, max_id + 1 + np.arange(pad, dtype=np.int64)]
    )
    return PatchLevel(
        D=D,
        n=pl.n,
        tree_level=pl.tree_level,
        ids=new_ids,
        starts=cat(pl.starts, 0.0, (D,)),
        spacings=cat(pl.spacings, 1.0, (D,)),
        refine_level=cat(pl.refine_level, 0, ()),
        parent_id=np.concatenate([pl.parent_id, new_ids[P_now:]]),  # own parent
        orth_on_parent=cat(pl.orth_on_parent, -1, ()),
        neumann=cat(pl.neumann, False, (S,)),
        nbr_type=cat(pl.nbr_type, 0, (S,)),
        nbr_slot=cat(pl.nbr_slot, -1, (S,)),
        coarse_orth=cat(pl.coarse_orth, -1, (S,)),
        fine_nbr_slots=cat(pl.fine_nbr_slots, -1, (S, half)),
        num_real=pl.real_patches,
    )


def patch_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for ``[P, ...]`` patch-field arrays."""
    return NamedSharding(mesh, P("p"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_patch_array(x: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    return jax.device_put(x, patch_sharding(mesh))
