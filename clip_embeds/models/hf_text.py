"""Encoder-LM text towers for CLIP (the reference's HFTextEncoder role).

Reference: open_clip/src/open_clip/hf_model.py:96 — wraps an HF AutoModel
(mt5, roberta, ...) with a pooler ('mean_pooler' default, 'cls_pooler') and an
MLP projection to the CLIP embed dim. Here the two encoder families already in
the framework are reused:

* ``T5TextTower`` — T5/mT5 encoder stack (models/t5.py), the tower behind the
  reference's mt5-base/xl CLIP configs (test_training_simple.py trains one).
* ``BertTextTower`` — post-LN BERT encoder built from the Q-Former blocks
  (models/blip2.py), the roberta-style family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from .blip2 import BertFFN, BertSelfAttention
from .layers import exact_gelu
from .t5 import T5Config, T5Stack

Dtype = Any


def mean_pool(hidden: jax.Array, mask: Optional[jax.Array]) -> jax.Array:
    """Masked mean over tokens (hf_model.py MeanPooler)."""
    if mask is None:
        return hidden.mean(axis=1)
    m = mask.astype(hidden.dtype)[..., None]
    return (hidden * m).sum(axis=1) / jnp.maximum(m.sum(axis=1), 1e-6)


class MLPProj(nn.Module):
    """hidden -> (hidden+embed)//2 -> embed with GELU (hf_model.py proj='mlp')."""

    embed_dim: int
    hidden_size: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        mid = (self.hidden_size + self.embed_dim) // 2
        x = nn.Dense(mid, use_bias=False, dtype=self.dtype, name="fc1")(x)
        x = exact_gelu(x)
        return nn.Dense(self.embed_dim, use_bias=False, dtype=self.dtype,
                        name="fc2")(x)


class T5TextTower(nn.Module):
    cfg: T5Config
    embed_dim: int
    pooler: str = "mean"  # 'mean' | 'first'
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        embeds = nn.Embed(
            self.cfg.vocab_size, self.cfg.d_model,
            embedding_init=nn.initializers.normal(1.0), dtype=self.dtype,
            name="shared",
        )(input_ids)
        hidden = T5Stack(self.cfg, is_decoder=False, dtype=self.dtype,
                         name="encoder")(embeds, attention_mask)
        pooled = (
            hidden[:, 0] if self.pooler == "first"
            else mean_pool(hidden, attention_mask)
        )
        return MLPProj(self.embed_dim, self.cfg.d_model, dtype=self.dtype,
                       name="proj")(pooled)


@dataclasses.dataclass(frozen=True)
class BertTextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    layer_norm_eps: float = 1e-5


class BertTextTower(nn.Module):
    cfg: BertTextConfig
    embed_dim: int
    pooler: str = "mean"
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.cfg
        n = input_ids.shape[1]
        x = nn.Embed(
            cfg.vocab_size, cfg.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="word_embeddings",
        )(input_ids)
        pos = nn.Embed(
            cfg.max_position_embeddings, cfg.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="position_embeddings",
        )(jnp.arange(n))
        x = x + pos[None]
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                         name="embed_ln")(x)
        mask = attention_mask[:, None, None, :] if attention_mask is not None else None
        for i in range(cfg.num_layers):
            x = BertSelfAttention(
                cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps,
                dtype=self.dtype, name=f"layer_{i}_attention",
            )(x, mask=mask)
            x = BertFFN(
                cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps,
                dtype=self.dtype, name=f"layer_{i}_ffn",
            )(x)
        pooled = x[:, 0] if self.pooler == "first" else mean_pool(
            x, attention_mask
        )
        return MLPProj(self.embed_dim, cfg.hidden_size, dtype=self.dtype,
                       name="proj")(pooled)


@dataclasses.dataclass(frozen=True)
class M2M100Config:
    """NLLB / M2M100 encoder shapes (HF facebook/nllb-200-* configs)."""

    vocab_size: int = 256206
    d_model: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5


def _m2m100_sinusoids(num: int, dim: int) -> jnp.ndarray:
    """fairseq/tensor2tensor sinusoidal table (HF modeling_m2m_100.py
    M2M100SinusoidalPositionalEmbedding.get_embedding: sin block then cos
    block, NOT interleaved; row padding_idx zeroed by position-id routing)."""
    import math

    half = dim // 2
    freq = jnp.exp(jnp.arange(half) * (-math.log(10000.0) / (half - 1)))
    ang = jnp.arange(num)[:, None] * freq[None, :]
    emb = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)], axis=1)
    if dim % 2 == 1:
        emb = jnp.concatenate([emb, jnp.zeros((num, 1))], axis=1)
    return emb


class M2M100TextTower(nn.Module):
    """NLLB text encoder (M2M100 encoder) + pooler + projection.

    Reference: open_clip routes nllb-clip-* text through HFTextEncoder with
    arch 'm2m_100' (hf_configs.py:56-69) using the CLS (first-token) pooler
    and a bias-free linear projection (model_configs/nllb-clip-base.json).
    Architecture per HF modeling_m2m_100.py M2M100Encoder: scaled token
    embeddings + offset-2 sinusoidal positions over cumulative non-pad
    position ids, pre-LN blocks (MHA, ReLU FFN), final LayerNorm.
    """

    cfg: M2M100Config
    embed_dim: int
    pooler: str = "first"  # cls_pooler
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).astype(jnp.int32)
        x = nn.Embed(
            cfg.vocab_size, cfg.d_model,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="embed_tokens",
        )(input_ids)
        x = x * jnp.asarray(cfg.d_model ** 0.5, self.dtype)

        # position ids: cumsum over non-pad tokens + padding_idx, pads stay
        # at padding_idx (create_position_ids_from_input_ids) and index the
        # sinusoid table directly (first real token = row padding_idx + 1;
        # HF zeroes the padding row, but padded tokens are attention-masked
        # and never pooled, so the row value is inert)
        mask = attention_mask.astype(jnp.int32)
        pos_ids = jnp.cumsum(mask, axis=1) * mask + cfg.pad_token_id
        table = _m2m100_sinusoids(
            cfg.max_position_embeddings + 2, cfg.d_model
        ).astype(self.dtype)
        x = x + table[pos_ids]

        nh = cfg.num_heads
        hd = cfg.d_model // nh
        kv_mask = attention_mask[:, None, None, :].astype(bool)
        for i in range(cfg.num_layers):
            h = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                             name=f"layer_{i}_attn_ln")(x)
            b, n, _ = h.shape

            def heads(t):
                return t.reshape(b, n, nh, hd).transpose(0, 2, 1, 3)

            q = heads(nn.Dense(cfg.d_model, dtype=self.dtype,
                               name=f"layer_{i}_q")(h)) * (hd ** -0.5)
            k = heads(nn.Dense(cfg.d_model, dtype=self.dtype,
                               name=f"layer_{i}_k")(h))
            v = heads(nn.Dense(cfg.d_model, dtype=self.dtype,
                               name=f"layer_{i}_v")(h))
            logits = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                                preferred_element_type=jnp.float32)
            logits = jnp.where(kv_mask, logits, -jnp.inf)
            probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
            o = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
            o = o.transpose(0, 2, 1, 3).reshape(b, n, cfg.d_model)
            x = x + nn.Dense(cfg.d_model, dtype=self.dtype,
                             name=f"layer_{i}_out")(o)

            h = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                             name=f"layer_{i}_final_ln")(x)
            h = nn.Dense(cfg.ffn_dim, dtype=self.dtype,
                         name=f"layer_{i}_fc1")(h)
            h = nn.relu(h)
            x = x + nn.Dense(cfg.d_model, dtype=self.dtype,
                             name=f"layer_{i}_fc2")(h)

        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                         name="layer_norm")(x)
        pooled = x[:, 0] if self.pooler == "first" else mean_pool(
            x, attention_mask
        )
        return nn.Dense(self.embed_dim, use_bias=False, dtype=self.dtype,
                        name="proj")(pooled)


def convert_m2m100_encoder_state_dict(
    sd, cfg: M2M100Config, prefix: str = "encoder."
) -> dict:
    """HF M2M100 encoder state dict -> M2M100TextTower params (proj
    excluded — open_clip checkpoints carry it as text.proj)."""
    import numpy as np

    def _np(t):
        return np.asarray(getattr(t, "detach", lambda: t)().cpu()) \
            if hasattr(t, "detach") else np.asarray(t)

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    def lin(pre):
        return {"kernel": _np(sd[pre + ".weight"]).T,
                "bias": _np(sd[pre + ".bias"])}

    def ln(pre):
        return {"scale": _np(sd[pre + ".weight"]),
                "bias": _np(sd[pre + ".bias"])}

    params = {
        "embed_tokens": {"embedding": _np(sd["embed_tokens.weight"])},
        "layer_norm": ln("layer_norm"),
    }
    for i in range(cfg.num_layers):
        pre = f"layers.{i}"
        params[f"layer_{i}_attn_ln"] = ln(f"{pre}.self_attn_layer_norm")
        params[f"layer_{i}_q"] = lin(f"{pre}.self_attn.q_proj")
        params[f"layer_{i}_k"] = lin(f"{pre}.self_attn.k_proj")
        params[f"layer_{i}_v"] = lin(f"{pre}.self_attn.v_proj")
        params[f"layer_{i}_out"] = lin(f"{pre}.self_attn.out_proj")
        params[f"layer_{i}_final_ln"] = ln(f"{pre}.final_layer_norm")
        params[f"layer_{i}_fc1"] = lin(f"{pre}.fc1")
        params[f"layer_{i}_fc2"] = lin(f"{pre}.fc2")
    return params
