"""Causal text transformer tower (flax.linen).

Matches the reference text path (open_clip/src/open_clip/model.py:283-301 +
transformer.py:858-1101): token embed + learned pos embed -> causal pre-LN
blocks -> ln_final -> argmax (EOT) pooling -> linear projection. Padding is
deliberately *not* masked in attention — CLIP never does — so converted
checkpoints reproduce reference activations exactly.

Always returns (pooled, tokens), subsuming the fork's ``output_text_tokens``
flag (model.py:251,299-301).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import TextConfig
from .layers import Transformer

Dtype = Any


def text_global_pool(
    x: jax.Array, text_ids: jax.Array, pool_type: str = "argmax"
) -> Tuple[jax.Array, jax.Array]:
    """Pool token features; 'argmax' picks the EOT position (highest token id).

    Reference: transformer.py:839-855.
    """
    if pool_type == "first":
        return x[:, 0], x[:, 1:]
    if pool_type == "last":
        return x[:, -1], x[:, :-1]
    if pool_type == "argmax":
        eot = jnp.argmax(text_ids, axis=-1)
        pooled = jnp.take_along_axis(x, eot[:, None, None], axis=1)[:, 0]
        return pooled, x
    return x, x


class TextTransformer(nn.Module):
    cfg: TextConfig
    embed_dim: int
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant: bool = False
    scan_layers: bool = False

    @nn.compact
    def __call__(self, text_ids: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """text_ids: int [B, ctx] -> (pooled [B, embed_dim], tokens [B, ctx, W])."""
        cfg = self.cfg
        embed = nn.Embed(
            cfg.vocab_size, cfg.width,
            embedding_init=nn.initializers.normal(0.02),
            dtype=self.dtype, name="token_embedding",
        )
        x = embed(text_ids)
        pos = self.param(
            "positional_embedding",
            nn.initializers.normal(0.01),
            (cfg.context_length, cfg.width),
        )
        x = x + pos[: x.shape[1]].astype(self.dtype)

        if self.scan_layers:
            from .layers import ScanTransformer

            transformer = ScanTransformer(
                cfg.width, cfg.layers, cfg.heads, cfg.mlp_ratio,
                self.quick_gelu, dtype=self.dtype, attn_impl=self.attn_impl,
                name="transformer",
            )
        else:
            transformer = Transformer(
                cfg.width, cfg.layers, cfg.heads, cfg.mlp_ratio,
                self.quick_gelu, dtype=self.dtype, attn_impl=self.attn_impl,
                remat=self.remat, quant=self.quant,
                name="transformer",
            )
        x = transformer(x, causal=not cfg.no_causal_mask)

        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_final")(x)
        pooled, tokens = text_global_pool(x, text_ids, cfg.pool_type)
        proj = self.param(
            "text_projection",
            nn.initializers.normal(cfg.width ** -0.5),
            (cfg.width, self.embed_dim),
        )
        pooled = pooled @ proj.astype(self.dtype)
        return pooled, tokens
