"""PartitionSpec rules for CLIP params over a (data, model) mesh.

Megatron-style tensor parallelism for the transformer blocks: QKV and MLP
up-projections shard their output features over the model axis; the following
down-projections shard their input features, so each block needs a single
all-reduce. Embedding-sized tensors stay replicated. (The reference has no TP
at all — SURVEY.md §2e; this exists for the big-tower/LLaVA path and for
exercising real multi-chip shardings in the dry run.)
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import MODEL_AXIS


_COLUMN_PARALLEL = (
    # CLIP blocks
    "attn/in_proj/kernel", "mlp/c_fc/kernel",
    # Llama/LLaVA trunk (SURVEY §7 stage 6: TP for the 7B decoder)
    "self_attn/q_proj/kernel", "self_attn/k_proj/kernel",
    "self_attn/v_proj/kernel",
    "mlp/gate_proj/kernel", "mlp/up_proj/kernel",
    "lm_head/kernel",
    # T5 encoder/decoder (CLIP-FlanT5, the reference's default VQAScore
    # backbone): per-head q/k/v columns + gated-GELU up-projections
    "self_attn/q/kernel", "self_attn/k/kernel", "self_attn/v/kernel",
    "cross_attn/q/kernel", "cross_attn/k/kernel", "cross_attn/v/kernel",
    "ff/wi_0/kernel", "ff/wi_1/kernel", "ff/wi/kernel",
)
_COLUMN_PARALLEL_BIAS = (
    "attn/in_proj/bias",
    "mlp/c_fc/bias",
    "self_attn/q_proj/bias", "self_attn/k_proj/bias",
    "self_attn/v_proj/bias",
)
_ROW_PARALLEL = (
    "attn/out_proj/kernel", "mlp/c_proj/kernel",
    "self_attn/o_proj/kernel", "mlp/down_proj/kernel",
    "self_attn/o/kernel", "cross_attn/o/kernel", "ff/wo/kernel",
)


def _spec_for_path(path: tuple) -> P:
    keys = [getattr(p, "key", str(p)) for p in path]
    joined = "/".join(keys)
    if joined.endswith(_COLUMN_PARALLEL):
        return P(None, MODEL_AXIS)  # column parallel
    if joined.endswith(_COLUMN_PARALLEL_BIAS):
        return P(MODEL_AXIS)
    if joined.endswith(_ROW_PARALLEL):
        return P(MODEL_AXIS, None)  # row parallel (one all-reduce per block)
    if joined.endswith("token_embedding/embedding"):
        return P(None, None)
    return P()  # replicate


def clip_param_specs(params: Any) -> Any:
    """PartitionSpec pytree matching a CLIP (or tower) param tree."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: _spec_for_path(path), params
    )


def _fits(leaf: Any, spec: P, mesh: Mesh) -> bool:
    """A spec applies only if every sharded dim divides its axis size
    (e.g. GQA kv projections may be narrower than the model axis)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if leaf.ndim <= dim or leaf.shape[dim] % mesh.shape[axis] != 0:
            return False
    return True


def shard_params(mesh: Mesh, params: Any) -> Any:
    specs = clip_param_specs(params)
    return jax.tree.map(
        lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s if _fits(x, s, mesh) else P())
        ),
        params, specs,
    )


def fsdp_param_specs(
    params: Any,
    mesh: Mesh,
    axis: str = "data",
    min_size: int = 2 ** 14,
) -> Any:
    """Fully-sharded (FSDP/ZeRO-3-style) PartitionSpecs over the data axis.

    Each large leaf shards its LARGEST divisible dimension across ``axis``;
    XLA inserts the per-layer all-gathers on use and reduce-scatters the
    gradients — the scaling-book fully_sharded recipe, no wrapper modules
    needed. Leaves smaller than ``min_size`` elements (biases, LN params,
    scalars) stay replicated: gathering them costs more latency than the
    memory saved. (The reference's torch DDP has no parameter sharding at
    all; this is the JAX extension past its scaling ceiling.)
    """
    n = mesh.shape[axis]

    def spec_for(leaf) -> P:
        if not hasattr(leaf, "ndim") or leaf.ndim == 0 \
                or leaf.size < min_size:
            return P()
        dims = sorted(
            range(leaf.ndim), key=lambda d: leaf.shape[d], reverse=True
        )
        for d in dims:
            if leaf.shape[d] % n == 0 and leaf.shape[d] >= n:
                spec = [None] * leaf.ndim
                spec[d] = axis
                return P(*spec)
        return P()

    return jax.tree.map(spec_for, params)


def fsdp_shard_params(
    mesh: Mesh, params: Any, axis: str = "data", min_size: int = 2 ** 14
) -> Any:
    """device_put the param tree with fsdp_param_specs shardings."""
    specs = fsdp_param_specs(params, mesh, axis, min_size)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs
    )


def zero1_opt_state_sharding(mesh: Mesh, opt_state: Any, axis: str = "data") -> Any:
    """Shard optimizer-moment leaves over the data axis (ZeRO-1 style).

    The reference's DDP replicates optimizer state on every GPU; under pjit we
    can instead shard the Adam mu/nu leaves across the mesh — params stay
    replicated, XLA inserts the gather/scatter around the update. Leaves whose
    leading dim does not divide the axis are left replicated.
    """
    n = mesh.shape[axis]

    def spec_for(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] % n == 0 \
                and leaf.shape[0] >= n:
            return NamedSharding(mesh, P(axis))
        return NamedSharding(mesh, P())

    return jax.tree.map(
        lambda leaf: jax.device_put(leaf, spec_for(leaf)), opt_state
    )
