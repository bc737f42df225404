"""SigLIP (ViT-SO400M family) dual encoder in flax.linen.

Reference: the VLM2Vec baseline eval uses HF google/siglip-so400m-patch14-384
(VLM2Vec/evaluation/eval_siglip.py:30-33) and the open_clip fork carries the
SigLIP loss (loss.py:377-530, implemented in losses/siglip.py). This module
supplies the model family itself so the baseline eval runs natively:

* vision: biased patchify, learned pos embed, NO class token, pre-norm blocks
  with tanh-GELU MLPs (hidden_act gelu_pytorch_tanh), post-LN, and a MAP head
  (learned probe cross-attention + LN + residual MLP, pool = probe output)
* text: token+pos embeds, same blocks, final LN, pooled = LAST token -> head
* similarity: logit_scale * cos + logit_bias (paired with SigLipLoss)

Weight layout follows HF SiglipModel so released checkpoints convert directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..ops.attention import dot_product_attention
from .clip import l2_normalize
from .vit import patchify

Dtype = Any


def tanh_gelu(x: jax.Array) -> jax.Array:
    return jax.nn.gelu(x, approximate=True)


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    image_size: int = 384
    patch_size: int = 14
    width: int = 1152          # so400m
    layers: int = 27
    heads: int = 16
    intermediate_size: int = 4304
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SiglipTextConfig:
    vocab_size: int = 32000
    width: int = 1152
    layers: int = 27
    heads: int = 16
    intermediate_size: int = 4304
    max_position_embeddings: int = 64
    layer_norm_eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    vision: SiglipVisionConfig = dataclasses.field(
        default_factory=SiglipVisionConfig
    )
    text: SiglipTextConfig = dataclasses.field(
        default_factory=SiglipTextConfig
    )


class SiglipBlock(nn.Module):
    width: int
    heads: int
    intermediate_size: int
    ln_eps: float
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: Any = False   # False | 'dynamic' | 'static' (models/quant.py)

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        from .quant import dense

        b, n, _ = x.shape
        hd = self.width // self.heads
        h = nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                         name="ln_1")(x)
        qkv = dense(self.quant, 3 * self.width, dtype=self.dtype,
                    name="in_proj")(h)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def heads(t):
            return t.reshape(b, n, self.heads, hd).transpose(0, 2, 1, 3)

        out = dot_product_attention(
            heads(q), heads(k), heads(v), impl=self.attn_impl
        )
        out = out.transpose(0, 2, 1, 3).reshape(b, n, self.width)
        x = x + dense(self.quant, self.width, dtype=self.dtype,
                      name="out_proj")(out)
        h = nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                         name="ln_2")(x)
        h = dense(self.quant, self.intermediate_size, dtype=self.dtype,
                  name="fc1")(h)
        h = tanh_gelu(h)
        return x + dense(self.quant, self.width, dtype=self.dtype,
                         name="fc2")(h)


class SiglipMAPHead(nn.Module):
    """Multihead attention pooling: learned probe attends over the tokens,
    then LN + residual MLP; the probe's output is the pooled feature."""

    width: int
    heads: int
    intermediate_size: int
    ln_eps: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, n, _ = x.shape
        hd = self.width // self.heads
        probe = self.param(
            "probe", nn.initializers.normal(0.02), (1, self.width)
        )
        # torch nn.MultiheadAttention packed in_proj over (q=probe, k=v=x)
        kernel = self.param(
            "in_proj_kernel", nn.initializers.lecun_normal(),
            (self.width, 3 * self.width),
        )
        bias = self.param(
            "in_proj_bias", nn.initializers.zeros, (3 * self.width,)
        )
        wq, wk, wv = jnp.split(kernel.astype(self.dtype), 3, axis=1)
        bq, bk, bv = jnp.split(bias.astype(self.dtype), 3)
        q = jnp.broadcast_to(
            (probe.astype(self.dtype) @ wq + bq)[None], (b, 1, self.width)
        )
        k = x @ wk + bk
        v = x @ wv + bv

        def heads(t, m):
            return t.reshape(b, m, self.heads, hd).transpose(0, 2, 1, 3)

        out = dot_product_attention(
            heads(q, 1), heads(k, n), heads(v, n), impl="reference"
        )
        out = out.transpose(0, 2, 1, 3).reshape(b, 1, self.width)
        out = nn.Dense(self.width, dtype=self.dtype, name="out_proj")(out)
        res = out
        h = nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                         name="ln")(out)
        h = nn.Dense(self.intermediate_size, dtype=self.dtype, name="fc1")(h)
        h = tanh_gelu(h)
        h = nn.Dense(self.width, dtype=self.dtype, name="fc2")(h)
        return (res + h)[:, 0]


class SiglipVisionTower(nn.Module):
    cfg: SiglipVisionConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: Any = False   # block projections only; patchify/MAP head stay fp

    @nn.compact
    def __call__(self, images: jax.Array) -> jax.Array:
        cfg = self.cfg
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        pos = self.param(
            "position_embedding", nn.initializers.normal(0.02),
            (x.shape[1], cfg.width),
        )
        x = x + pos.astype(self.dtype)
        for i in range(cfg.layers):
            x = SiglipBlock(
                cfg.width, cfg.heads, cfg.intermediate_size,
                cfg.layer_norm_eps, dtype=self.dtype,
                attn_impl=self.attn_impl, quant=self.quant,
                name=f"blocks_{i}",
            )(x)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                         name="post_layernorm")(x)
        return SiglipMAPHead(
            cfg.width, cfg.heads, cfg.intermediate_size, cfg.layer_norm_eps,
            dtype=self.dtype, name="head",
        )(x)


class SiglipTextTower(nn.Module):
    cfg: SiglipTextConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: Any = False   # block projections only; embeds/head stay fp

    @nn.compact
    def __call__(self, input_ids: jax.Array) -> jax.Array:
        cfg = self.cfg
        n = input_ids.shape[1]
        x = nn.Embed(
            cfg.vocab_size, cfg.width,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="token_embedding",
        )(input_ids)
        pos = self.param(
            "position_embedding", nn.initializers.normal(0.02),
            (cfg.max_position_embeddings, cfg.width),
        )
        x = x + pos[:n].astype(self.dtype)
        for i in range(cfg.layers):
            x = SiglipBlock(
                cfg.width, cfg.heads, cfg.intermediate_size,
                cfg.layer_norm_eps, dtype=self.dtype,
                attn_impl=self.attn_impl, quant=self.quant,
                name=f"blocks_{i}",
            )(x)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                         name="final_layer_norm")(x)
        # SigLIP pools the LAST token then projects
        return nn.Dense(cfg.width, dtype=self.dtype, name="head")(x[:, -1])


class Siglip(nn.Module):
    cfg: SiglipConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: Any = False   # vision-tower block projections (calibration route)

    def setup(self):
        self.vision_model = SiglipVisionTower(
            self.cfg.vision, dtype=self.dtype, attn_impl=self.attn_impl,
            quant=self.quant,
        )
        self.text_model = SiglipTextTower(
            self.cfg.text, dtype=self.dtype, attn_impl=self.attn_impl,
            quant=self.quant,
        )
        self.logit_scale = self.param(
            "logit_scale", nn.initializers.constant(jnp.log(10.0)), ()
        )
        self.logit_bias = self.param(
            "logit_bias", nn.initializers.constant(-10.0), ()
        )

    def encode_image(self, images, normalize: bool = True):
        x = self.vision_model(images)
        return l2_normalize(x) if normalize else x

    def encode_text(self, input_ids, normalize: bool = True):
        x = self.text_model(input_ids)
        return l2_normalize(x) if normalize else x

    def __call__(self, images, input_ids) -> Dict[str, jax.Array]:
        img = self.encode_image(images)
        txt = self.encode_text(input_ids)
        return {
            "image_features": img,
            "text_features": txt,
            "logit_scale": jnp.exp(self.logit_scale),
            "logit_bias": self.logit_bias,
            # logits_per_text (HF convention): t @ i^T * scale + bias
            "logits_per_text": (
                jnp.exp(self.logit_scale) * txt @ img.T + self.logit_bias
            ),
        }


def convert_siglip_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF SiglipModel -> Siglip params."""
    import numpy as np

    from ..core.torch_convert import _layernorm, _linear, _np

    sd = dict(sd)

    def blocks(prefix: str) -> Dict[str, Any]:
        n = 0
        while f"{prefix}.encoder.layers.{n}.layer_norm1.weight" in sd:
            n += 1
        out: Dict[str, Any] = {}
        for i in range(n):
            pre = f"{prefix}.encoder.layers.{i}"
            qw = _np(sd[f"{pre}.self_attn.q_proj.weight"])
            kw = _np(sd[f"{pre}.self_attn.k_proj.weight"])
            vw = _np(sd[f"{pre}.self_attn.v_proj.weight"])
            qb = _np(sd[f"{pre}.self_attn.q_proj.bias"])
            kb = _np(sd[f"{pre}.self_attn.k_proj.bias"])
            vb = _np(sd[f"{pre}.self_attn.v_proj.bias"])
            out[f"blocks_{i}"] = {
                "ln_1": _layernorm(sd, f"{pre}.layer_norm1"),
                "in_proj": {
                    "kernel": np.concatenate([qw, kw, vw], axis=0).T,
                    "bias": np.concatenate([qb, kb, vb]),
                },
                "out_proj": _linear(sd, f"{pre}.self_attn.out_proj"),
                "ln_2": _layernorm(sd, f"{pre}.layer_norm2"),
                "fc1": _linear(sd, f"{pre}.mlp.fc1"),
                "fc2": _linear(sd, f"{pre}.mlp.fc2"),
            }
        return out

    conv_w = _np(sd["vision_model.embeddings.patch_embedding.weight"])
    width, cin, p, _ = conv_w.shape
    vision = dict(
        blocks("vision_model"),
        patch_embed={
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width),
            "bias": _np(sd["vision_model.embeddings.patch_embedding.bias"]),
        },
        position_embedding=_np(
            sd["vision_model.embeddings.position_embedding.weight"]
        ),
        post_layernorm=_layernorm(sd, "vision_model.post_layernorm"),
        head={
            "probe": _np(sd["vision_model.head.probe"]).reshape(1, -1),
            "in_proj_kernel": _np(
                sd["vision_model.head.attention.in_proj_weight"]
            ).T,
            "in_proj_bias": _np(sd["vision_model.head.attention.in_proj_bias"]),
            "out_proj": _linear(sd, "vision_model.head.attention.out_proj"),
            "ln": _layernorm(sd, "vision_model.head.layernorm"),
            "fc1": _linear(sd, "vision_model.head.mlp.fc1"),
            "fc2": _linear(sd, "vision_model.head.mlp.fc2"),
        },
    )
    text = dict(
        blocks("text_model"),
        token_embedding={
            "embedding": _np(sd["text_model.embeddings.token_embedding.weight"])
        },
        position_embedding=_np(
            sd["text_model.embeddings.position_embedding.weight"]
        ),
        final_layer_norm=_layernorm(sd, "text_model.final_layer_norm"),
        head=_linear(sd, "text_model.head"),
    )
    return {
        "vision_model": vision,
        "text_model": text,
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
        "logit_bias": _np(sd["logit_bias"]).reshape(()),
    }
