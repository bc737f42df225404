"""Attention dispatch.

Every model calls :func:`dot_product_attention` on [B, H, N, D] tensors. The
reference ran attention through torch's fused SDPA
(open_clip/src/open_clip/transformer.py:161-166) and flash-attention-2
(VLM2Vec/src/model.py:92,103). Here the route is picked from static facts of
the call (:func:`attention_route`):

* ``"cudnn"``: cuDNN's fused flash attention, forward and backward, through
  ``jax.nn.dot_product_attention(implementation="cudnn")``. Taken on a GPU
  for bf16/fp16 operands whose head dim cuDNN accepts.
* ``"reference"``: :func:`reference_attention`, float32 logits and softmax
  in plain XLA. Taken everywhere else; it is also the oracle of the tests.

``impl="xla"`` runs the cuDNN route's own plumbing (layout, padding, masks)
through ``jax.nn.dot_product_attention``'s XLA form, so that it is testable
where there is no GPU. PERF.md has the timings that chose the routes.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

_CUDNN_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
# cuDNN's flash attention on Hopper: head dim a multiple of 8, at most 256.
_CUDNN_MAX_HEAD_DIM = 256


def reference_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    causal: bool = False,
    mask: Optional[jax.Array] = None,
) -> jax.Array:
    """Plain XLA attention. q,k,v: [B, H, N, D]; mask: bool [B?, 1?, Nq, Nk].

    A causal mask with Nq < Nk is aligned to the bottom-right corner: the
    last query sees every key (a suffix over a cached prefix)."""
    dim = q.shape[-1]
    scale = dim ** -0.5
    logits = jnp.einsum(
        "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
    ) * scale
    if causal:
        nq, nk = logits.shape[-2], logits.shape[-1]
        causal_mask = jnp.tril(jnp.ones((nq, nk), dtype=bool), k=nk - nq)
        logits = jnp.where(causal_mask, logits, -jnp.inf)
    if mask is not None:
        logits = jnp.where(mask, logits, -jnp.inf)
    probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
    return jnp.einsum("bhqk,bhkd->bhqd", probs, v)


def attention_route(dtype, head_dim: int, platform: str) -> str:
    """'cudnn' or 'reference' for operands of this dtype and head dim on
    this platform ('gpu', 'cpu', ...)."""
    if (platform == "gpu" and jnp.dtype(dtype) in _CUDNN_DTYPES
            and head_dim % 8 == 0 and head_dim <= _CUDNN_MAX_HEAD_DIM):
        return "cudnn"
    return "reference"


def _fused_attention(q, k, v, causal, mask, implementation: str):
    """[B, H, N, D] attention through ``jax.nn.dot_product_attention``.

    cuDNN aligns a causal mask to the top-left corner, so a causal call with
    Nq != Nk passes its bottom-right triangle as a boolean mask (which cuDNN
    takes as an additive bias). Its backward pass refuses odd sequence
    lengths in this JAX version, so odd lengths are padded by one: a padded
    key is masked out (by length, or in the mask), a padded query row is
    sliced off.
    """
    b, _, nq, _ = q.shape
    nk = k.shape[2]
    if causal and nq != nk:
        tri = jnp.tril(jnp.ones((nq, nk), dtype=bool), k=nk - nq)
        mask = tri if mask is None else jnp.logical_and(mask, tri)
        causal = False
    if mask is not None:
        mask = mask.reshape((1,) * (4 - mask.ndim) + mask.shape)
        mask = jnp.broadcast_to(mask, mask.shape[:2] + (nq, nk))
    pad_q, pad_k = nq % 2, nk % 2
    kv_lengths = None
    if pad_q or pad_k:
        def pad(t, n):
            return jnp.pad(t, ((0, 0), (0, 0), (0, n), (0, 0)))

        q, k, v = pad(q, pad_q), pad(k, pad_k), pad(v, pad_k)
        if mask is not None:
            mask = jnp.pad(mask, ((0, 0), (0, 0), (0, pad_q), (0, pad_k)))
        elif pad_k and not causal:
            # a causal query never reaches the trailing pad key
            kv_lengths = jnp.full((b,), nk, jnp.int32)

    def bnhd(t):  # [B, H, N, D] <-> [B, N, H, D]; XLA folds these into
        return t.transpose(0, 2, 1, 3)  # the producer's reshape

    out = jax.nn.dot_product_attention(
        bnhd(q), bnhd(k), bnhd(v), mask=mask, is_causal=causal,
        key_value_seq_lengths=kv_lengths, implementation=implementation,
    )
    return bnhd(out)[:, :, :nq]


def dot_product_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    causal: bool = False,
    mask: Optional[jax.Array] = None,
    impl: str = "auto",
) -> jax.Array:
    """Multi-head attention on [B, H, N, D] tensors.

    impl: 'auto' (:func:`attention_route` on the default backend),
    'reference', 'cudnn', or 'xla' (the cuDNN route's plumbing in XLA).
    mask: bool, broadcastable to [B, H, Nq, Nk]; True attends.
    """
    if impl == "auto":
        impl = attention_route(q.dtype, q.shape[-1], jax.default_backend())
    if impl == "reference":
        return reference_attention(q, k, v, causal=causal, mask=mask)
    if impl in ("cudnn", "xla"):
        return _fused_attention(q, k, v, causal, mask, impl)
    raise ValueError(f"unknown attention impl {impl!r}")
