"""PACL / SPARC patch-aligned projection heads.

Reference: Patch-Aligned-Contrastive-Learning/model/pacl.py. The heads are
small trainable modules on top of a *frozen* CLIP tower (pacl.py:97
requires_grad=False — here the tower simply runs under stop_gradient or is
precomputed). Variant semantics reproduced exactly:

* ``open_clip_pacl`` (pacl.py:51-145): LN -> Dropout -> PatchProjection on
  patch tokens; LN -> Dropout -> Linear on the text CLS; sigmoid(10 * cosine)
  patch activations (:120-133). The committed forward overrides activations
  with ones ("Eval only !!!!!!", :141-143) — ``pooling='uniform'``; the
  commented-out training path is ``pooling='weighted'``.
* ``open_clip_pacl_rope`` (:184-197): RoPE on raw patches before projection,
  uniform pooling.
* ``open_clip_pacl_rope_after`` (:199-209): RoPE on *projections* for the
  activation computation only; pooling weights the unrotated projections (no
  uniform override).
* ``sparc`` (:380-485): same visual projection; text projection applied to all
  text tokens; language mask = positions <= argmax(ids) (:431-436).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from .clip import l2_normalize
from .layers import exact_gelu

Dtype = Any


def apply_rope(embeddings: jax.Array) -> jax.Array:
    """The paper's RoPE ablation transform (pacl.py:147-181).

    Note: splits even/odd channels but *concatenates* (not interleaves) the
    rotated halves — reproduced as-is.
    """
    _, seq_len, dim = embeddings.shape
    assert dim % 2 == 0
    inv_freq = 1.0 / (10000 ** (jnp.arange(0, dim, 2, dtype=jnp.float32) / dim))
    angles = jnp.arange(seq_len, dtype=jnp.float32)[:, None] * inv_freq[None, :]
    sin, cos = jnp.sin(angles)[None], jnp.cos(angles)[None]
    x1 = embeddings[..., 0::2]
    x2 = embeddings[..., 1::2]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


class PatchProjection(nn.Module):
    """Linear + (Linear->GELU->Linear) residual pair (pacl.py:35-48)."""

    out_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        linear = nn.Dense(self.out_dim, dtype=self.dtype, name="linear")(x)
        h = nn.Dense(self.out_dim, dtype=self.dtype, name="mlp_in")(x)
        h = exact_gelu(h)
        h = nn.Dense(self.out_dim, dtype=self.dtype, name="mlp_out")(h)
        return linear + h


class _ProjStack(nn.Module):
    out_dim: int
    patch: bool
    dropout: float = 0.1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln")(x)
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
        if self.patch:
            return PatchProjection(self.out_dim, self.dtype, name="proj")(x)
        return nn.Dense(self.out_dim, dtype=self.dtype, name="proj")(x)


def patch_alignment(visual_patch_proj: jax.Array, text_cls_proj: jax.Array) -> jax.Array:
    """sigmoid(10 * cosine(patch, text)) activations [B, P] (pacl.py:120-133)."""
    v = l2_normalize(visual_patch_proj)
    t = l2_normalize(text_cls_proj)
    acts = jnp.einsum("bpd,bd->bp", v, t, preferred_element_type=jnp.float32)
    return jax.nn.sigmoid(acts * 10.0)


class PACLHead(nn.Module):
    """Trainable PACL projections over frozen tower outputs.

    Call with patch tokens [B, P, Dv] and a text embedding [B, Dt] (either the
    CLIP text CLS or a precomputed LLM2Vec embedding — the llm2clip variants,
    pacl.py:212-291, differ only in Dt and the frozen tower).
    """

    proj_dim: int
    rope: str = "none"  # 'none' | 'before' | 'after'
    pooling: str = "uniform"  # 'uniform' (committed eval) | 'weighted'
    dropout: float = 0.1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        visual_patches: jax.Array,
        text_embedding: jax.Array,
        train: bool = False,
    ) -> Tuple[jax.Array, jax.Array]:
        visual_patches = jax.lax.stop_gradient(visual_patches)
        text_embedding = jax.lax.stop_gradient(text_embedding)

        if self.rope == "before":
            visual_patches = apply_rope(visual_patches)
        vproj = _ProjStack(
            self.proj_dim, patch=True, dropout=self.dropout,
            dtype=self.dtype, name="visual_projection",
        )(visual_patches, train)
        tproj = _ProjStack(
            self.proj_dim, patch=False, dropout=self.dropout,
            dtype=self.dtype, name="text_projection",
        )(text_embedding, train)

        if self.rope == "after":
            acts = patch_alignment(apply_rope(vproj), tproj)
        elif self.pooling == "uniform":
            acts = jnp.ones(vproj.shape[:2], vproj.dtype)
        else:
            acts = patch_alignment(vproj, tproj)

        pooled = jnp.einsum("bpd,bp->bd", vproj, acts.astype(vproj.dtype))
        return l2_normalize(pooled), l2_normalize(tproj)


class SPARCHead(nn.Module):
    """SPARC projections: patches [B,P,Dv] + text tokens [B,T,Dt]."""

    proj_dim: int
    rope: bool = False
    dropout: float = 0.1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        visual_patches: jax.Array,
        text_tokens: jax.Array,
        train: bool = False,
    ) -> Tuple[jax.Array, jax.Array]:
        visual_patches = jax.lax.stop_gradient(visual_patches)
        text_tokens = jax.lax.stop_gradient(text_tokens)
        if self.rope:
            visual_patches = apply_rope(visual_patches)
        vproj = _ProjStack(
            self.proj_dim, patch=True, dropout=self.dropout,
            dtype=self.dtype, name="visual_projection",
        )(visual_patches, train)
        tproj = _ProjStack(
            self.proj_dim, patch=False, dropout=self.dropout,
            dtype=self.dtype, name="text_projection",
        )(text_tokens, train)
        return vproj, tproj


def language_mask_from_ids(text_ids: jax.Array) -> jax.Array:
    """Float mask over token positions <= EOT argmax (pacl.py:431-436)."""
    eot = jnp.argmax(text_ids, axis=-1)
    pos = jnp.arange(text_ids.shape[1])[None, :]
    return (pos <= eot[:, None]).astype(jnp.float32)
