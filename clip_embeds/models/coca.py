"""CoCa: contrastive captioner (flax.linen).

Reference: open_clip/src/open_clip/coca_model.py + transformer.py:
* vision: ViT trunk -> 256-query AttentionalPooler -> ln_post -> 'tok' pool
  (transformer.py:190-210 pooler; VisionTransformer _pool "original OpenCLIP
  CoCa setup" branch)
* text: CLS token appended at the END (embed_cls, transformer.py:977-990),
  causal mask + the cls-row pad mask (build_cls_mask :968-975), pooled = last
  token -> ln_final -> projection; unpooled tokens feed the decoder
* decoder: interleaved causal self-attention + cross-attention blocks over the
  pooled image tokens, ln_final, projection to the vocab (MultimodalTransformer
  :1104-1215; output_dim == vocab_size per coca_model.py:127-133)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import TextConfig, VisionConfig
from ..ops.attention import reference_attention
from .clip import l2_normalize
from .layers import MLP, MultiHeadAttention, ResidualAttentionBlock, Transformer
from .vit import patchify

Dtype = Any


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    context_length: int = 76
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class CoCaConfig:
    embed_dim: int = 512
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=32, width=768, layers=12
        )
    )
    text: TextConfig = dataclasses.field(
        default_factory=lambda: TextConfig(context_length=76)
    )
    multimodal: MultimodalConfig = dataclasses.field(
        default_factory=MultimodalConfig
    )
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592
    pad_id: int = 0


class AttentionalPooler(nn.Module):
    """Learned-query cross attention (transformer.py:190-210)."""

    d_model: int
    context_dim: int
    n_head: int = 8
    n_queries: int = 256
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b = x.shape[0]
        query = self.param(
            "query", nn.initializers.normal(1.0), (self.n_queries, self.d_model)
        )
        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_k")(x)
        q_in = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_q")(
            query.astype(self.dtype)
        )
        q = nn.Dense(self.d_model, dtype=self.dtype, name="q_proj")(q_in)
        k = nn.Dense(self.d_model, dtype=self.dtype, name="k_proj")(x)
        v = nn.Dense(self.d_model, dtype=self.dtype, name="v_proj")(x)

        hd = self.d_model // self.n_head
        q = jnp.broadcast_to(
            q.reshape(1, self.n_queries, self.n_head, hd), (b, self.n_queries, self.n_head, hd)
        ).transpose(0, 2, 1, 3)
        k = k.reshape(b, -1, self.n_head, hd).transpose(0, 2, 1, 3)
        v = v.reshape(b, -1, self.n_head, hd).transpose(0, 2, 1, 3)
        out = reference_attention(q, k, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, self.n_queries, self.d_model)
        return nn.Dense(self.d_model, dtype=self.dtype, name="out_proj")(out)


class CoCaVisionTower(nn.Module):
    cfg: CoCaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """-> (image_latent [B, E], image_tokens [B, n_queries-1, E])."""
        cfg = self.cfg
        v = cfg.vision
        b = images.shape[0]
        scale = v.width ** -0.5
        x = patchify(images.astype(self.dtype), v.patch_size)
        x = nn.Dense(v.width, use_bias=False, dtype=self.dtype,
                     name="patch_embed")(x)
        cls = self.param("class_embedding", nn.initializers.normal(scale),
                         (v.width,))
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, v.width)), x],
            axis=1,
        )
        pos = self.param(
            "positional_embedding", nn.initializers.normal(scale),
            (x.shape[1], v.width),
        )
        x = x + pos.astype(self.dtype)
        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_pre")(x)
        x = Transformer(
            v.width, v.layers, v.heads, v.mlp_ratio, cfg.quick_gelu,
            dtype=self.dtype, attn_impl=self.attn_impl, remat=self.remat,
            name="transformer",
        )(x)
        x = AttentionalPooler(
            cfg.embed_dim, v.width, cfg.attn_pooler_heads,
            cfg.attn_pooler_queries, dtype=self.dtype, name="attn_pool",
        )(x)
        x = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_post")(x)
        pooled, tokens = x[:, 0], x[:, 1:]
        proj = self.param(
            "proj", nn.initializers.normal(cfg.embed_dim ** -0.5),
            (cfg.embed_dim, cfg.embed_dim),
        )
        return pooled @ proj.astype(self.dtype), tokens


class CoCaTextTower(nn.Module):
    cfg: CoCaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    @nn.compact
    def __call__(self, text_ids: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """-> (text_latent [B, E], token_embs [B, L, W] un-normed)."""
        cfg = self.cfg
        t = cfg.text
        b, l = text_ids.shape
        embed = nn.Embed(
            t.vocab_size, t.width,
            embedding_init=nn.initializers.normal(0.02),
            dtype=self.dtype, name="token_embedding",
        )
        x = embed(text_ids)
        cls_emb = self.param(
            "cls_emb", nn.initializers.normal(0.01), (t.width,)
        )
        x = jnp.concatenate(
            [x, jnp.broadcast_to(cls_emb.astype(self.dtype), (b, 1, t.width))],
            axis=1,
        )
        pos = self.param(
            "positional_embedding", nn.initializers.normal(0.01),
            (t.context_length + 1, t.width),
        )
        x = x + pos[: l + 1].astype(self.dtype)

        # causal mask + cls-row pad mask (reference build_cls_mask semantics:
        # only the appended cls query row excludes pad keys; the first key
        # column is always visible to it)
        n = l + 1
        causal = jnp.tril(jnp.ones((n, n), bool))
        not_pad = text_ids != cfg.pad_id                 # [B, L]
        cls_row = jnp.concatenate(
            [jnp.ones((b, 1), bool), not_pad], axis=1
        )                                                 # [B, 1+L]
        mask = jnp.broadcast_to(causal[None], (b, n, n))
        mask = mask.at[:, -1, :].set(mask[:, -1, :] & cls_row)
        mask = mask[:, None, :, :]                        # [B, 1, n, n]

        blocks = Transformer(
            t.width, t.layers, t.heads, t.mlp_ratio, cfg.quick_gelu,
            dtype=self.dtype, attn_impl="reference", remat=self.remat,
            name="transformer",
        )
        x = blocks(x, causal=False, mask=mask)

        pooled = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_final")(
            x[:, -1]
        )
        proj = self.param(
            "text_projection", nn.initializers.normal(t.width ** -0.5),
            (t.width, cfg.embed_dim),
        )
        return pooled @ proj.astype(self.dtype), x[:, :-1]


class MultimodalDecoder(nn.Module):
    """Interleaved causal self-attn + image cross-attn blocks -> vocab logits."""

    cfg: CoCaConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, image_embs: jax.Array, text_embs: jax.Array) -> jax.Array:
        m = self.cfg.multimodal
        for i in range(m.layers):
            block = ResidualAttentionBlock(
                m.width, m.heads, m.mlp_ratio, self.cfg.quick_gelu,
                dtype=self.dtype, attn_impl="reference",
                name=f"resblocks_{i}",
            )
            text_embs = block(text_embs, causal=True)
            text_embs = CrossAttentionBlock(
                m.width, m.heads, m.mlp_ratio, self.cfg.quick_gelu,
                dtype=self.dtype, name=f"cross_attn_{i}",
            )(text_embs, image_embs)
        out = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_final")(
            text_embs
        )
        proj = self.param(
            "text_projection", nn.initializers.normal(m.width ** -0.5),
            (m.width, self.cfg.text.vocab_size),
        )
        return out @ proj.astype(self.dtype)


class CrossAttentionBlock(nn.Module):
    """Pre-LN residual block with cross attention (is_cross_attention=True,
    transformer.py:213-268: ln_1 on queries, ln_1_kv on keys/values)."""

    width: int
    heads: int
    mlp_ratio: float = 4.0
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, context: jax.Array) -> jax.Array:
        q_in = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_1")(x)
        kv_in = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_1_kv")(
            context
        )
        b, nq, _ = q_in.shape
        hd = self.width // self.heads
        # torch's packed in_proj: one [W, 3W] kernel whose q slice reads the
        # text stream and k/v slices read the image context
        kernel_param = self.param(
            "in_proj_kernel", nn.initializers.lecun_normal(),
            (self.width, 3 * self.width),
        )
        bias_param = self.param(
            "in_proj_bias", nn.initializers.zeros, (3 * self.width,)
        )
        wq, wk, wv = jnp.split(kernel_param.astype(self.dtype), 3, axis=1)
        bq, bk, bv = jnp.split(bias_param.astype(self.dtype), 3)
        q = q_in @ wq + bq
        k = kv_in @ wk + bk
        v = kv_in @ wv + bv

        def split(t):
            return t.reshape(b, -1, self.heads, hd).transpose(0, 2, 1, 3)

        out = reference_attention(split(q), split(k), split(v))
        out = out.transpose(0, 2, 1, 3).reshape(b, nq, self.width)
        out = nn.Dense(self.width, dtype=self.dtype, name="out_proj")(out)
        x = x + out
        mlp = MLP(self.width, self.mlp_ratio, self.quick_gelu,
                  dtype=self.dtype, name="mlp")
        x = x + mlp(nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln_2")(x))
        return x


class CoCa(nn.Module):
    cfg: CoCaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        self.visual = CoCaVisionTower(
            self.cfg, self.dtype, self.attn_impl, self.remat
        )
        self.text = CoCaTextTower(
            self.cfg, self.dtype, self.attn_impl, self.remat
        )
        self.text_decoder = MultimodalDecoder(self.cfg, self.dtype, self.remat)
        self.logit_scale = self.param(
            "logit_scale",
            nn.initializers.constant(self.cfg.init_logit_scale), (),
        )

    def encode_image(self, images, normalize: bool = True):
        latent, _ = self.visual(images)
        return l2_normalize(latent) if normalize else latent

    def encode_text(self, text_ids, normalize: bool = True):
        latent, _ = self.text(text_ids)
        return l2_normalize(latent) if normalize else latent

    def image_tokens(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """(latent, pooled image tokens) — encode once for generation."""
        return self.visual(images)

    def caption_logits(
        self, image_embs: jax.Array, text_ids: jax.Array
    ) -> jax.Array:
        """Decoder logits [B, L, vocab] over a fixed text buffer (causal, so
        positions past the current length are ignorable — the generate loop
        reads only logits[:, cur_len-1])."""
        _, token_embs = self.text(text_ids)
        return self.text_decoder(image_embs, token_embs)

    def __call__(
        self, images: jax.Array, text_ids: jax.Array, output_labels: bool = True
    ) -> Dict[str, jax.Array]:
        """Contrastive latents + teacher-forced caption logits
        (coca_model.py:251-286)."""
        image_latent, image_embs = self.visual(images)
        text_latent, token_embs = self.text(text_ids)
        labels = text_ids[:, 1:] if output_labels else None
        if output_labels:
            token_embs = token_embs[:, :-1]
        logits = self.text_decoder(image_embs, token_embs)
        out = {
            "image_features": l2_normalize(image_latent),
            "text_features": l2_normalize(text_latent),
            "logits": logits,
            "logit_scale": jnp.exp(self.logit_scale),
        }
        if labels is not None:
            out["labels"] = labels
        return out
