"""SigLIP sigmoid loss: global (pjit) and ppermute-ring (shard_map) variants.

Reference: open_clip/src/open_clip/loss.py:377-530 — SigLipLoss with
dist_impl in {bidir, shift, reduce, gather}. The torch ring streams text
features between neighbours with batched isend/irecv and a custom autograd
Function (loss.py:280-374); here the exact analogue is `jax.lax.ppermute`,
which is differentiable by construction.

* ``siglip_loss`` — global-batch form for pjit: mathematically equal to the
  summed ring (per-rank mean over DDP == global sum / global batch).
* ``siglip_loss_ring`` — explicit shard_map form: O(local_b x local_b) logits
  per step, negatives stream around the ring (ppermute, which XLA hands to
  NCCL on GPUs). Use when the global
  logit matrix would not fit.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P


def _sigmoid_pair_loss(
    image_features: jax.Array,
    text_features: jax.Array,
    logit_scale: jax.Array,
    logit_bias: Optional[jax.Array],
    negative_only: bool,
) -> jax.Array:
    """-sum(logsigmoid(labels * logits)) / local_batch (reference _loss)."""
    logits = logit_scale * jnp.einsum(
        "id,jd->ij", image_features, text_features,
        preferred_element_type=jnp.float32,
    )
    if logit_bias is not None:
        logits = logits + logit_bias
    labels = -jnp.ones_like(logits)
    if not negative_only:
        labels = labels + 2 * jnp.eye(logits.shape[0], logits.shape[1])
    return -jax.nn.log_sigmoid(labels * logits).sum() / image_features.shape[0]


def siglip_loss(
    image_features: jax.Array,
    text_features: jax.Array,
    logit_scale: jax.Array,
    logit_bias: Optional[jax.Array] = None,
) -> jax.Array:
    """Global-batch sigmoid loss (all pairs, positives on the diagonal)."""
    return _sigmoid_pair_loss(
        image_features, text_features, logit_scale, logit_bias,
        negative_only=False,
    )


def _ring_loss_local(
    image_features: jax.Array,
    text_features: jax.Array,
    logit_scale: jax.Array,
    logit_bias: Optional[jax.Array],
    axis_name: str,
) -> jax.Array:
    """Per-shard body: positives locally, then stream negatives ring-wise."""
    world = lax.axis_size(axis_name)
    perm = [(j, (j + 1) % world) for j in range(world)]
    loss = _sigmoid_pair_loss(
        image_features, text_features, logit_scale, logit_bias,
        negative_only=False,
    )

    def body(_, carry):
        neigh_text, acc = carry
        neigh_text = lax.ppermute(neigh_text, axis_name, perm)
        acc = acc + _sigmoid_pair_loss(
            image_features, neigh_text, logit_scale, logit_bias,
            negative_only=True,
        )
        return neigh_text, acc

    if world > 1:
        _, loss = lax.fori_loop(0, world - 1, body, (text_features, loss))
    # mean over shards == DDP gradient averaging semantics
    return lax.pmean(loss, axis_name)


def siglip_loss_ring(
    image_features: jax.Array,
    text_features: jax.Array,
    logit_scale: jax.Array,
    logit_bias: Optional[jax.Array],
    mesh: Mesh,
    axis_name: str = "data",
) -> jax.Array:
    """Ring-streamed sigmoid loss over a data-sharded mesh (shard_map)."""
    fn = jax.shard_map(
        partial(_ring_loss_local, axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(), P() if logit_bias is not None else None),
        out_specs=P(),
    )
    if logit_bias is None:
        fn = jax.shard_map(
            lambda i, t, s: _ring_loss_local(i, t, s, None, axis_name),
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P()),
            out_specs=P(),
        )
        return fn(image_features, text_features, logit_scale)
    return fn(image_features, text_features, logit_scale, logit_bias)
