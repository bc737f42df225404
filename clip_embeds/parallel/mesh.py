"""Device mesh + sharding helpers.

Replaces the reference's torch.distributed process-group bootstrap
(open_clip/src/open_clip_train/distributed.py:93-195, backend table nccl/hccl/
ccl/gloo) with a single jax.sharding.Mesh: data axis for batch sharding and an
optional model axis for tensor parallelism (needed only for the 7B LLaVA stack,
SURVEY.md §2e). Collectives come from jit/shard_map; XLA hands them to NCCL
on GPUs, so there is no process group to manage. The mesh follows the
algorithm alone: every card of a host reaches every other at the same rate.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Create a (data, model) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    assert n_data * n_model == len(devices), (
        f"{n_data}x{n_model} mesh does not tile {len(devices)} devices"
    )
    grid = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def constrain(x: jax.Array, *axes) -> jax.Array:
    """Mesh-aware ``with_sharding_constraint`` that is a no-op off-mesh.

    ``axes`` is one entry per dim of ``x``: a mesh axis name or None. The
    constraint is applied only when an ambient mesh (jax.sharding.set_mesh)
    is in scope AND it carries at least one of the named axes; otherwise
    ``x`` passes through untouched — single-chip jits keep identical HLO
    (and their persistent-compile-cache keys). Axis names missing from the
    ambient mesh degrade to None rather than erroring, so the same model
    code runs on (data,), (data, model), or FSDP-only meshes.

    This is the fix for the round-2 SPMD "involuntary full rematerialization"
    warnings: the Megatron PartitionSpecs (sharding_rules.py) constrain only
    the weights, which leaves the partitioner free to pick pathological
    layouts for attention intermediates; anchoring the activations here
    keeps every resharding explicit and cheap.
    """
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty:
        return x
    spec = tuple(a if (a is None or a in mesh.shape) else None for a in axes)
    if all(a is None for a in spec):
        return x
    return jax.lax.with_sharding_constraint(x, P(*spec))


def batch_spec() -> P:
    """Shard the leading (batch) dim over the data axis, replicate the rest."""
    return P(DATA_AXIS)


def replicated_spec() -> P:
    return P()


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec())


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, replicated_spec())


def shard_batch(mesh: Mesh, batch):
    """Place a host pytree onto the mesh, sharded along the leading axis."""
    sharding = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), batch)
