"""BLIP-2 Q-Former retrieval stack (ITM / ITC heads) in flax.linen.

JAX equivalent of the vendored-LAVIS BLIP-2 used by the reference's
ITMScore and CLIPScore BLIP2-ITC models (t2v_metrics itmscore_models/
blip2_itm_model.py, clipscore_models via lavis Qformer.py). Architecture
follows the public HF Blip2ForImageTextRetrieval semantics so Salesforce
blip2-itm checkpoints convert directly:

* vision tower: EVA-style ViT — biased patchify, no pre-LN, post-LN at the
  end, LN eps 1e-6 (Blip2VisionModel)
* Q-Former: post-LN BERT layers over [query tokens; text tokens] with image
  cross-attention on the query slice every ``cross_attention_frequency``
  layers, and separate FFN weights for the query slice
* ITM: itm_head over query outputs, mean over queries (2-way logits)
* ITC: max over query embeddings of cosine(query, text CLS)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .layers import Transformer, exact_gelu
from .vit import patchify

Dtype = Any


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=14, width=1408, layers=39,
            head_width=88, mlp_ratio=6144 / 1408,
        )
    )
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    num_query_tokens: int = 32
    image_text_hidden_size: int = 256


class Blip2VisionTower(nn.Module):
    cfg: VisionConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"

    @nn.compact
    def __call__(self, images: jax.Array) -> jax.Array:
        """[B, S, S, 3] -> [B, 1+N, W] (post-LN'd hidden states)."""
        cfg = self.cfg
        b = images.shape[0]
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        cls = self.param(
            "class_embedding", nn.initializers.normal(0.02), (cfg.width,)
        )
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1,
        )
        pos = self.param(
            "positional_embedding", nn.initializers.normal(0.02),
            (x.shape[1], cfg.width),
        )
        x = x + pos.astype(self.dtype)
        x = Transformer(
            cfg.width, cfg.layers, cfg.heads, cfg.mlp_ratio,
            quick_gelu=False, dtype=self.dtype, attn_impl=self.attn_impl,
            ln_eps=1e-6, name="transformer",
        )(x)
        return nn.LayerNorm(epsilon=1e-6, dtype=self.dtype,
                            name="post_layernorm")(x)


class BertSelfAttention(nn.Module):
    """BERT-style attention with separate q/k/v and post-LN output."""

    hidden_size: int
    num_heads: int
    ln_eps: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        hidden: jax.Array,
        kv: Optional[jax.Array] = None,
        mask: Optional[jax.Array] = None,  # bool [B, 1, Nq, Nk]
    ) -> jax.Array:
        kv = hidden if kv is None else kv
        b, nq, _ = hidden.shape
        nk = kv.shape[1]
        hd = self.hidden_size // self.num_heads
        q = nn.Dense(self.hidden_size, dtype=self.dtype, name="query")(hidden)
        k = nn.Dense(self.hidden_size, dtype=self.dtype, name="key")(kv)
        v = nn.Dense(self.hidden_size, dtype=self.dtype, name="value")(kv)

        def split(t, n):
            return t.reshape(b, n, self.num_heads, hd).transpose(0, 2, 1, 3)

        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", split(q, nq), split(k, nk),
            preferred_element_type=jnp.float32,
        ) * (hd ** -0.5)
        if mask is not None:
            logits = jnp.where(mask, logits, -1e9)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bhkd->bhqd", probs, split(v, nk))
        out = out.transpose(0, 2, 1, 3).reshape(b, nq, self.hidden_size)
        # post-LN residual output block
        out = nn.Dense(self.hidden_size, dtype=self.dtype, name="out_dense")(out)
        return nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                            name="out_ln")(out + hidden)


class BertFFN(nn.Module):
    hidden_size: int
    intermediate_size: int
    ln_eps: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        h = nn.Dense(self.intermediate_size, dtype=self.dtype,
                     name="intermediate")(x)
        h = exact_gelu(h)
        h = nn.Dense(self.hidden_size, dtype=self.dtype, name="output")(h)
        return nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                            name="ln")(h + x)


class QFormerLayer(nn.Module):
    cfg: QFormerConfig
    has_cross_attention: bool
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        hidden: jax.Array,            # [B, Q+T, D]
        image_embeds: Optional[jax.Array],
        self_mask: Optional[jax.Array],
        query_length: int,
    ) -> jax.Array:
        cfg = self.cfg
        hidden = BertSelfAttention(
            cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps,
            dtype=self.dtype, name="attention",
        )(hidden, mask=self_mask)

        if query_length > 0:
            query_part = hidden[:, :query_length]
            text_part = hidden[:, query_length:]
            if self.has_cross_attention:
                query_part = BertSelfAttention(
                    cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps,
                    dtype=self.dtype, name="crossattention",
                )(query_part, kv=image_embeds)
            query_part = BertFFN(
                cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps,
                dtype=self.dtype, name="ffn_query",
            )(query_part)
            if text_part.shape[1] > 0:
                text_part = BertFFN(
                    cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps,
                    dtype=self.dtype, name="ffn",
                )(text_part)
                return jnp.concatenate([query_part, text_part], axis=1)
            return query_part
        return BertFFN(
            cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps,
            dtype=self.dtype, name="ffn",
        )(hidden)


class QFormer(nn.Module):
    cfg: QFormerConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        query_embeds: jax.Array,                  # [B, Q(+T), D] pre-layernorm
        image_embeds: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,  # bool [B, Q+T]
        query_length: int = 0,
    ) -> jax.Array:
        cfg = self.cfg
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                         name="input_ln")(query_embeds)
        self_mask = None
        if attention_mask is not None:
            self_mask = attention_mask[:, None, None, :]
        for i in range(cfg.num_layers):
            x = QFormerLayer(
                cfg, has_cross_attention=(i % cfg.cross_attention_frequency == 0),
                dtype=self.dtype, name=f"layer_{i}",
            )(x, image_embeds, self_mask, query_length)
        return x


class Blip2ITM(nn.Module):
    """BLIP-2 image-text matching / contrastive retrieval model."""

    cfg: Blip2Config
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"

    def setup(self):
        q = self.cfg.qformer
        self.vision_model = Blip2VisionTower(
            self.cfg.vision, dtype=self.dtype, attn_impl=self.attn_impl
        )
        self.query_tokens = self.param(
            "query_tokens", nn.initializers.zeros,
            (self.cfg.num_query_tokens, q.hidden_size),
        )
        self.word_embeddings = nn.Embed(
            q.vocab_size, q.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="word_embeddings",
        )
        self.position_embeddings = nn.Embed(
            q.max_position_embeddings, q.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="position_embeddings",
        )
        self.qformer = QFormer(q, dtype=self.dtype)
        self.vision_projection = nn.Dense(
            self.cfg.image_text_hidden_size, dtype=self.dtype
        )
        self.text_projection = nn.Dense(
            self.cfg.image_text_hidden_size, dtype=self.dtype
        )
        self.itm_head = nn.Dense(2, dtype=self.dtype)

    def _text_embeds(self, input_ids: jax.Array) -> jax.Array:
        n = input_ids.shape[1]
        pos = self.position_embeddings(jnp.arange(n))[None]
        return self.word_embeddings(input_ids) + pos.astype(self.dtype)

    def itm_logits(
        self,
        pixel_values: jax.Array,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """2-way match logits [B, 2] for aligned (image, text) rows."""
        image_embeds = self.vision_model(pixel_values)
        b = image_embeds.shape[0]
        nq = self.cfg.num_query_tokens
        queries = jnp.broadcast_to(
            self.query_tokens[None].astype(self.dtype),
            (b, nq, self.query_tokens.shape[-1]),
        )
        text = self._text_embeds(input_ids)
        hidden = jnp.concatenate([queries, text], axis=1)
        if attention_mask is None:
            attention_mask = jnp.ones(input_ids.shape, bool)
        mask = jnp.concatenate(
            [jnp.ones((b, nq), bool), attention_mask.astype(bool)], axis=1
        )
        out = self.qformer(hidden, image_embeds, mask, query_length=nq)
        return self.itm_head(out[:, :nq]).mean(axis=1)

    def itc_embeds(
        self,
        pixel_values: Optional[jax.Array] = None,
        input_ids: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
    ) -> Tuple[Optional[jax.Array], Optional[jax.Array]]:
        """(image query embeds [B, Q, E] normalized, text CLS embeds [B, E])."""
        image_out = text_out = None
        if pixel_values is not None:
            image_embeds = self.vision_model(pixel_values)
            b = image_embeds.shape[0]
            nq = self.cfg.num_query_tokens
            queries = jnp.broadcast_to(
                self.query_tokens[None].astype(self.dtype),
                (b, nq, self.query_tokens.shape[-1]),
            )
            out = self.qformer(queries, image_embeds, None, query_length=nq)
            proj = self.vision_projection(out)
            image_out = proj / jnp.linalg.norm(proj, axis=-1, keepdims=True)
        if input_ids is not None:
            text = self._text_embeds(input_ids)
            mask = (
                attention_mask.astype(bool)
                if attention_mask is not None
                else jnp.ones(input_ids.shape, bool)
            )
            out = self.qformer(text, None, mask, query_length=0)
            proj = self.text_projection(out[:, 0])
            text_out = proj / jnp.linalg.norm(proj, axis=-1, keepdims=True)
        return image_out, text_out

    def itc_logits(
        self,
        pixel_values: jax.Array,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """logits_per_image [B_img, B_txt]: max over queries of cosine."""
        image_out, text_out = self.itc_embeds(
            pixel_values, input_ids, attention_mask
        )
        sims = jnp.einsum("bqe,te->bqt", image_out, text_out)
        return sims.max(axis=1)
