"""Scan-based GradCache: exact big-batch contrastive gradients, chunked memory.

JAX port of the reference's two-pass engine
(VLM2Vec/grad_cache/grad_cache.py:244-279) following its vendored JAX design
template (grad_cache/cachex/functional.py:12-50):

  1. chunked no-grad encode  ->  full-batch representations
  2. loss grad wrt representations (the "cache")
  3. chunked re-forward, pulling the cached cotangents back through the
     encoder with jax.vjp

The torch version needs RNG capture/replay (context_managers.py:5-21) for
bit-exact re-forwards; JAX PRNG keys are explicit so replay is free. Gradient
accumulation with cached-feature replay (open_clip_train/train.py:113-162) is
the same computation — both are served by this module.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp


def tree_chunk(tree: Any, n_chunks: int) -> Any:
    """Reshape leading axis B -> [n_chunks, B/n_chunks] on every leaf."""
    return jax.tree.map(
        lambda x: x.reshape(n_chunks, x.shape[0] // n_chunks, *x.shape[1:]), tree
    )


def tree_unchunk(tree: Any) -> Any:
    """Inverse of tree_chunk: merge the two leading axes."""
    return jax.tree.map(
        lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), tree
    )


def chunked_encode(
    encode_fn: Callable[[Any, Any], Any],
    params: Any,
    chunked_batch: Any,
) -> Any:
    """lax.map the encoder over chunks without building a grad graph."""
    reps = jax.lax.map(
        lambda chunk: encode_fn(params, chunk),
        jax.lax.stop_gradient(chunked_batch),
    )
    return tree_unchunk(reps)


def cache_grad_step(
    encode_fn: Callable[[Any, Any], Any],
    loss_fn: Callable[[Any], jax.Array],
    params: Any,
    batch: Any,
    n_chunks: int,
) -> Tuple[jax.Array, Any]:
    """(loss, param_grads) for loss_fn(encode_fn(params, batch)), computed with
    only one chunk's activations live at a time.

    encode_fn(params, chunk) -> reps pytree with leading axis = chunk size.
    loss_fn(full_reps) -> scalar over the *full* batch (global negatives).
    """
    chunked = tree_chunk(batch, n_chunks)

    # Pass 1: representations without activation storage.
    reps = chunked_encode(encode_fn, params, chunked)

    # Loss + cotangent wrt representations (the cache).
    loss, rep_grads = jax.value_and_grad(loss_fn)(reps)
    rep_grads = tree_chunk(rep_grads, n_chunks)

    # Pass 2: pull cached cotangents back through the encoder chunk by chunk.
    zero_grads = jax.tree.map(jnp.zeros_like, params)

    def body(acc, chunk_and_cot):
        chunk, cotangent = chunk_and_cot
        _, vjp = jax.vjp(lambda p: encode_fn(p, chunk), params)
        (g,) = vjp(cotangent)
        return jax.tree.map(jnp.add, acc, g), None

    grads, _ = jax.lax.scan(body, zero_grads, (chunked, rep_grads))
    return loss, grads
