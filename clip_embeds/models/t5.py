"""T5 encoder-decoder (flax.linen) for the CLIP-FlanT5 VQAScore stack.

Matches the HF T5 v1.1 / Flan-T5 architecture consumed by the reference's
CLIPT5ForConditionalGeneration (t2v_metrics clip_t5 models; vendored
lavis/models/blip2_models/modeling_t5.py is the same family):
* T5LayerNorm — RMS without mean subtraction, no bias
* unscaled attention (no 1/sqrt(d); folded into init)
* bucketed relative position bias, owned by the first self-attention layer of
  each stack and shared down the stack
* gated-GELU feed-forward (wi_0/wi_1/wo) with no biases
* independent lm_head (v1.1 untied) with optional d_model^-0.5 scaling when
  tied
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

Dtype = Any


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_decoder_layers: Optional[int] = None
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    tie_word_embeddings: bool = False
    feed_forward_proj: str = "gated-gelu"  # or 'relu'

    @property
    def decoder_layers(self) -> int:
        return self.num_decoder_layers or self.num_layers


def t5_tiny_config() -> T5Config:
    return T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_heads=4)


class T5LayerNorm(nn.Module):
    eps: float = 1e-6
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        weight = self.param("weight", nn.initializers.ones, (x.shape[-1],))
        var = jnp.mean(x.astype(jnp.float32) ** 2, axis=-1, keepdims=True)
        x = x * jax.lax.rsqrt(var + self.eps).astype(x.dtype)
        return (x * weight.astype(x.dtype)).astype(self.dtype)


def relative_position_bucket(
    relative_position: jax.Array,
    bidirectional: bool,
    num_buckets: int,
    max_distance: int,
) -> jax.Array:
    """HF T5 bucket function (modeling_t5.py _relative_position_bucket)."""
    ret = 0
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret += (n < 0).astype(jnp.int32) * num_buckets
        n = jnp.abs(n)
    else:
        n = jnp.maximum(n, 0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        jnp.log(n.astype(jnp.float32) / max_exact + 1e-6)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(jnp.int32)
    val_if_large = jnp.minimum(val_if_large, num_buckets - 1)
    return ret + jnp.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    cfg: T5Config
    has_relative_bias: bool = False
    bidirectional: bool = True
    dtype: Dtype = jnp.float32
    quant: str = ""  # '' | 'dynamic' | 'static' W8A8 projections (quant.py)

    @nn.compact
    def __call__(
        self,
        hidden: jax.Array,                     # [B, Nq, D]
        kv: Optional[jax.Array] = None,        # [B, Nk, D] for cross-attn
        mask: Optional[jax.Array] = None,      # bool [B, 1, Nq, Nk]
        position_bias: Optional[jax.Array] = None,  # [1, H, Nq, Nk]
    ) -> Tuple[jax.Array, Optional[jax.Array]]:
        from .quant import dense as make_dense

        cfg = self.cfg
        kv = hidden if kv is None else kv
        b, nq, _ = hidden.shape
        nk = kv.shape[1]
        inner = cfg.num_heads * cfg.d_kv

        q = make_dense(self.quant, inner, use_bias=False, dtype=self.dtype,
                       name="q")(hidden)
        k = make_dense(self.quant, inner, use_bias=False, dtype=self.dtype,
                       name="k")(kv)
        v = make_dense(self.quant, inner, use_bias=False, dtype=self.dtype,
                       name="v")(kv)

        def split(t, n):
            return t.reshape(b, n, cfg.num_heads, cfg.d_kv).transpose(0, 2, 1, 3)

        q, k, v = split(q, nq), split(k, nk), split(v, nk)

        if position_bias is None and self.has_relative_bias:
            rel_embed = nn.Embed(
                cfg.relative_attention_num_buckets, cfg.num_heads,
                embedding_init=nn.initializers.normal(1.0),
                dtype=self.dtype, name="relative_attention_bias",
            )
            ctx = jnp.arange(nk)[None, :] - jnp.arange(nq)[:, None]
            buckets = relative_position_bucket(
                ctx, self.bidirectional,
                cfg.relative_attention_num_buckets,
                cfg.relative_attention_max_distance,
            )
            position_bias = rel_embed(buckets).transpose(2, 0, 1)[None]

        # NOTE: T5 attention is unscaled
        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
        )
        if position_bias is not None:
            logits = logits + position_bias.astype(jnp.float32)
        if mask is not None:
            logits = jnp.where(mask, logits, -1e9)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, nq, inner)
        out = make_dense(self.quant, cfg.d_model, use_bias=False,
                         dtype=self.dtype, name="o")(out)
        return out, position_bias


class T5FeedForward(nn.Module):
    cfg: T5Config
    dtype: Dtype = jnp.float32
    quant: str = ""

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        from .quant import dense as make_dense

        cfg = self.cfg
        if cfg.feed_forward_proj == "gated-gelu":
            g = make_dense(self.quant, cfg.d_ff, use_bias=False,
                           dtype=self.dtype, name="wi_0")(x)
            u = make_dense(self.quant, cfg.d_ff, use_bias=False,
                           dtype=self.dtype, name="wi_1")(x)
            h = jax.nn.gelu(g, approximate=True) * u
        else:
            h = nn.relu(make_dense(self.quant, cfg.d_ff, use_bias=False,
                                   dtype=self.dtype, name="wi")(x))
        return make_dense(self.quant, cfg.d_model, use_bias=False,
                          dtype=self.dtype, name="wo")(h)


class T5Block(nn.Module):
    cfg: T5Config
    is_decoder: bool = False
    has_relative_bias: bool = False
    dtype: Dtype = jnp.float32
    quant: str = ""

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        self_mask: Optional[jax.Array],
        position_bias: Optional[jax.Array],
        encoder_out: Optional[jax.Array] = None,
        cross_mask: Optional[jax.Array] = None,
    ):
        cfg = self.cfg
        h = T5LayerNorm(cfg.layer_norm_epsilon, self.dtype,
                        name="self_ln")(x)
        attn_out, position_bias = T5Attention(
            cfg, self.has_relative_bias, bidirectional=not self.is_decoder,
            dtype=self.dtype, quant=self.quant, name="self_attn",
        )(h, mask=self_mask, position_bias=position_bias)
        x = x + attn_out
        if self.is_decoder and encoder_out is not None:
            h = T5LayerNorm(cfg.layer_norm_epsilon, self.dtype,
                            name="cross_ln")(x)
            cross_out, _ = T5Attention(
                cfg, False, dtype=self.dtype, quant=self.quant,
                name="cross_attn",
            )(h, kv=encoder_out, mask=cross_mask)
            x = x + cross_out
        h = T5LayerNorm(cfg.layer_norm_epsilon, self.dtype, name="ff_ln")(x)
        x = x + T5FeedForward(cfg, self.dtype, quant=self.quant,
                              name="ff")(h)
        return x, position_bias


class T5Stack(nn.Module):
    cfg: T5Config
    is_decoder: bool = False
    dtype: Dtype = jnp.float32
    quant: str = ""

    @nn.compact
    def __call__(
        self,
        embeds: jax.Array,
        attention_mask: Optional[jax.Array] = None,  # bool [B, N]
        encoder_out: Optional[jax.Array] = None,
        encoder_mask: Optional[jax.Array] = None,    # bool [B, Nk]
    ) -> jax.Array:
        cfg = self.cfg
        b, n, _ = embeds.shape
        self_mask = None
        if attention_mask is not None:
            self_mask = attention_mask[:, None, None, :]
        if self.is_decoder:
            causal = jnp.tril(jnp.ones((n, n), bool))[None, None]
            self_mask = causal if self_mask is None else (self_mask & causal)
        cross_mask = None
        if encoder_mask is not None:
            cross_mask = encoder_mask[:, None, None, :]

        x = embeds
        position_bias = None
        layers = cfg.decoder_layers if self.is_decoder else cfg.num_layers
        for i in range(layers):
            x, position_bias = T5Block(
                cfg, self.is_decoder, has_relative_bias=(i == 0),
                dtype=self.dtype, quant=self.quant, name=f"block_{i}",
            )(x, self_mask, position_bias, encoder_out, cross_mask)
        return T5LayerNorm(cfg.layer_norm_epsilon, self.dtype,
                           name="final_ln")(x)


class T5ForConditionalGeneration(nn.Module):
    cfg: T5Config
    dtype: Dtype = jnp.float32
    quant: str = ""  # W8A8 encoder+decoder projections; lm_head stays fp

    def setup(self):
        self.shared = nn.Embed(
            self.cfg.vocab_size, self.cfg.d_model,
            embedding_init=nn.initializers.normal(1.0),
            dtype=self.dtype, name="shared",
        )
        self.encoder = T5Stack(self.cfg, is_decoder=False, dtype=self.dtype,
                               quant=self.quant)
        self.decoder = T5Stack(self.cfg, is_decoder=True, dtype=self.dtype,
                               quant=self.quant)
        if not self.cfg.tie_word_embeddings:
            self.lm_head = nn.Dense(
                self.cfg.vocab_size, use_bias=False, dtype=self.dtype,
                name="lm_head",
            )

    def encode(
        self,
        input_ids: Optional[jax.Array] = None,
        inputs_embeds: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        if inputs_embeds is None:
            inputs_embeds = self.shared(input_ids)
        return self.encoder(inputs_embeds, attention_mask)

    def decode(
        self,
        decoder_input_ids: jax.Array,
        encoder_out: jax.Array,
        decoder_attention_mask: Optional[jax.Array] = None,
        encoder_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        x = self.shared(decoder_input_ids)
        x = self.decoder(x, decoder_attention_mask, encoder_out, encoder_mask)
        if self.cfg.tie_word_embeddings:
            x = x * (self.cfg.d_model ** -0.5)
            return self.shared.attend(x)
        return self.lm_head(x)

    def __call__(
        self,
        input_ids: Optional[jax.Array],
        decoder_input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
        inputs_embeds: Optional[jax.Array] = None,
    ) -> jax.Array:
        enc = self.encode(input_ids, inputs_embeds, attention_mask)
        return self.decode(
            decoder_input_ids, enc, decoder_attention_mask, attention_mask
        )


def shift_right(labels: jax.Array, decoder_start_token_id: int = 0,
                pad_id: int = 0) -> jax.Array:
    """HF T5._shift_right: prepend start token, drop last, scrub -100."""
    shifted = jnp.concatenate(
        [jnp.full((labels.shape[0], 1), decoder_start_token_id, labels.dtype),
         labels[:, :-1]], axis=1,
    )
    return jnp.where(shifted == -100, pad_id, shifted)
