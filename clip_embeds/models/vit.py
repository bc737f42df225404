"""Vision Transformer tower (flax.linen), channels-last and matmul-friendly.

Matches the reference tower (open_clip/src/open_clip/transformer.py:515-836):
patchify -> [CLS; patches] + learned pos embed -> ln_pre -> pre-LN blocks ->
ln_post -> pool ('tok') -> linear projection. Patchify is expressed as a
reshape + one large matmul (identical math to the stride-p conv at
transformer.py:549-556 but one GEMM for the tensor cores).

Always returns (pooled, tokens) — the callers decide what to keep, subsuming
the reference's mutable ``output_tokens`` flag (transformer.py:833-834).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .layers import Transformer

Dtype = Any


def patchify(images: jax.Array, patch_size: int) -> jax.Array:
    """[B, H, W, C] -> [B, gh*gw, p*p*C] with (ph, pw, c) minor ordering.

    Non-divisible sizes crop the bottom/right remainder — torch Conv2d
    valid-padding semantics (e.g. SigLIP so400m-patch14-384: 384//14 = 27
    patches, the trailing 6 pixels are dropped)."""
    b, h, w, c = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    if h != gh * p or w != gw * p:
        images = images[:, : gh * p, : gw * p]
    x = images.reshape(b, gh, p, gw, p, c)
    x = x.transpose(0, 1, 3, 2, 4, 5)  # [B, gh, gw, p, p, C]
    return x.reshape(b, gh * gw, p * p * c)


def interpolate_pos_embed(
    pos_embed: jax.Array, old_grid: int, new_grid: int
) -> jax.Array:
    """Bilinearly resample the patch grid of a [1+N, D] pos embed to a new grid.

    Reference behaviour: PACL's 196->625 interpolation
    (Patch-Aligned-Contrastive-Learning/model/pacl.py:103-110), torch
    F.interpolate(bilinear, align_corners=False) == jax.image.resize bilinear.
    """
    cls_pe, patch_pe = pos_embed[:1], pos_embed[1:]
    d = patch_pe.shape[-1]
    grid = patch_pe.reshape(old_grid, old_grid, d)
    grid = jax.image.resize(grid, (new_grid, new_grid, d), method="bilinear")
    return jnp.concatenate([cls_pe, grid.reshape(new_grid * new_grid, d)], axis=0)


class VisionTransformer(nn.Module):
    cfg: VisionConfig
    embed_dim: int
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant: bool = False
    scan_layers: bool = False

    @nn.compact
    def __call__(
        self,
        images: jax.Array,
        hidden_layer: Optional[int] = None,
        deterministic: bool = True,
    ) -> Tuple[jax.Array, jax.Array]:
        """images: [B, H, W, 3] float -> (pooled [B, embed_dim], tokens [B, N, W]).

        With ``hidden_layer`` set (e.g. -2), returns the raw hidden states
        [B, 1+N, W] after the corresponding block, HF hidden_states indexing
        (no ln_post, no projection) — the LLaVA feature tap.

        ``deterministic=False`` enables train-time patch dropout when
        cfg.patch_dropout > 0 (needs an rng under the 'patch_dropout' key).
        """
        cfg = self.cfg
        b = images.shape[0]
        scale = cfg.width ** -0.5

        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(
            cfg.width, use_bias=False, dtype=self.dtype, name="patch_embed"
        )(x)

        cls = self.param(
            "class_embedding", nn.initializers.normal(scale), (cfg.width,)
        )
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x], axis=1
        )
        num_pos = x.shape[1]
        pos = self.param(
            "positional_embedding",
            nn.initializers.normal(scale),
            (num_pos, cfg.width),
        )
        x = x + pos.astype(self.dtype)

        if not deterministic and cfg.patch_dropout > 0.0:
            # FLIP patch dropout (reference transformer.py:48-88): keep a
            # static count of patch tokens per sample, CLS always retained.
            # Random per-sample subset via uniform-noise top-k (matching the
            # reference's randn topk selection in distribution) — static
            # shapes so the whole train step stays one compiled program.
            n_patches = x.shape[1] - 1
            keep = max(1, int(n_patches * (1.0 - cfg.patch_dropout)))
            rng = self.make_rng("patch_dropout")
            noise = jax.random.uniform(rng, (b, n_patches))
            keep_idx = jax.lax.top_k(noise, keep)[1]             # [B, keep]
            patches = jnp.take_along_axis(
                x[:, 1:], keep_idx[..., None], axis=1
            )
            x = jnp.concatenate([x[:, :1], patches], axis=1)

        if not cfg.no_ln_pre:
            x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_pre")(x)

        if self.scan_layers:
            from .layers import ScanTransformer

            assert hidden_layer is None, "hidden tap needs unrolled layers"
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
        if hidden_layer is not None:
            # hidden_states[k] is the input of block k; index -2 therefore
            # skips the last block.
            return transformer(x, num_blocks=cfg.layers + 1 + hidden_layer)
        x = transformer(x)

        ln_post = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_post")
        if cfg.final_ln_after_pool:
            pooled, tokens = self._pool(x)
            pooled = ln_post(pooled)
        else:
            x = ln_post(x)
            pooled, tokens = self._pool(x)

        proj = self.param(
            "proj", nn.initializers.normal(scale), (cfg.width, self.embed_dim)
        )
        pooled = pooled @ proj.astype(self.dtype)
        return pooled, tokens

    def _pool(self, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
        if self.cfg.pool_type == "avg":
            return x[:, 1:].mean(axis=1), x[:, 1:]
        if self.cfg.pool_type == "tok":
            return x[:, 0], x[:, 1:]
        return x, x


def sincos_2d_pos_embed(width: int, grid_size: int, cls_token: bool = True) -> jnp.ndarray:
    """Fixed 2D sin-cos positional embedding [*1+N, width].

    Reference: open_clip/src/open_clip/pos_embed.py:20 get_2d_sincos_pos_embed
    (MoCo-v3 convention: half the channels encode the row position, half the
    column, each as interleaved sin/cos of scaled inverse frequencies).
    """
    assert width % 4 == 0
    quarter = width // 4
    omega = 1.0 / (10000.0 ** (jnp.arange(quarter, dtype=jnp.float32) / quarter))
    pos = jnp.arange(grid_size, dtype=jnp.float32)
    # reference convention ("w goes first", pos_embed.py:27-30): the first
    # half of the channels encodes the column index, the second half the row
    grid_col = jnp.tile(pos, grid_size)
    grid_row = jnp.repeat(pos, grid_size)

    def encode(coords):
        angles = jnp.outer(coords, omega)
        return jnp.concatenate([jnp.sin(angles), jnp.cos(angles)], axis=1)

    embed = jnp.concatenate([encode(grid_col), encode(grid_row)], axis=1)
    if cls_token:
        embed = jnp.concatenate([jnp.zeros((1, width)), embed], axis=0)
    return embed
