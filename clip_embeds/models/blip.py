"""BLIP-1 (med) text encoder + ViT tower, and the ImageReward ITM scorer.

Reference: t2v_metrics itmscore_models/image_reward_model.py:53-72 — BLIP
visual_encoder (timm-style ViT-L) feeds a med BertModel (BERT whose every
layer has image cross-attention, vendored lavis/models/med.py); the CLS
hidden state goes through ImageReward's activation-free MLP chain
(THUDM/ImageReward MLP: Linear 768->1024->128->64->16->1 with the ReLUs
commented out upstream) and is standardized by the checkpoint's mean/std.

The BERT blocks reuse models/blip2.py's post-LN attention/FFN modules; the
vision tower is the timm-ViT layout (biased patchify, cls+pos, pre-norm
blocks with fused qkv bias, final LN) shared with models/eva.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .blip2 import BertFFN, BertSelfAttention
from .layers import Transformer
from .vit import patchify

Dtype = Any


@dataclasses.dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524          # BLIP adds [DEC]/[ENC] tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=16, width=1024, layers=24,
            head_width=64,
        )
    )
    text: BlipTextConfig = dataclasses.field(default_factory=BlipTextConfig)


class BlipVisionTower(nn.Module):
    """timm-style ViT returning all post-norm hidden states [B, 1+N, W]."""

    cfg: VisionConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> jax.Array:
        cfg = self.cfg
        b = images.shape[0]
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        cls = self.param("cls_token", nn.initializers.normal(0.02),
                         (cfg.width,))
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1,
        )
        pos = self.param("pos_embed", nn.initializers.normal(0.02),
                         (x.shape[1], cfg.width))
        x = x + pos.astype(self.dtype)
        x = Transformer(
            cfg.width, cfg.layers, cfg.heads, cfg.mlp_ratio,
            quick_gelu=False, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat, ln_eps=1e-6, name="blocks",
        )(x)
        return nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm")(x)


class BlipTextLayer(nn.Module):
    """med BertLayer in encoder mode: self-attn, image cross-attn, FFN —
    all post-LN residual blocks."""

    cfg: BlipTextConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        hidden: jax.Array,
        image_embeds: Optional[jax.Array],
        self_mask: Optional[jax.Array],
    ) -> jax.Array:
        cfg = self.cfg
        hidden = BertSelfAttention(
            cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps,
            dtype=self.dtype, name="attention",
        )(hidden, mask=self_mask)
        if image_embeds is not None:
            hidden = BertSelfAttention(
                cfg.hidden_size, cfg.num_heads, cfg.layer_norm_eps,
                dtype=self.dtype, name="crossattention",
            )(hidden, kv=image_embeds)
        return BertFFN(
            cfg.hidden_size, cfg.intermediate_size, cfg.layer_norm_eps,
            dtype=self.dtype, name="ffn",
        )(hidden)


class BlipTextEncoder(nn.Module):
    """med BertModel (encoder mode): embeddings + N cross-attending layers."""

    cfg: BlipTextConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        input_ids: jax.Array,                       # [B, L]
        image_embeds: Optional[jax.Array] = None,   # [B, Nv, Wv]
        attention_mask: Optional[jax.Array] = None,  # bool [B, L]
    ) -> jax.Array:
        cfg = self.cfg
        n = input_ids.shape[1]
        words = nn.Embed(
            cfg.vocab_size, cfg.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="word_embeddings",
        )(input_ids)
        pos = nn.Embed(
            cfg.max_position_embeddings, cfg.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="position_embeddings",
        )(jnp.arange(n))
        x = nn.LayerNorm(
            epsilon=cfg.layer_norm_eps, dtype=self.dtype, name="embeddings_ln"
        )(words + pos[None].astype(self.dtype))
        self_mask = None
        if attention_mask is not None:
            self_mask = attention_mask[:, None, None, :]
        for i in range(cfg.num_layers):
            x = BlipTextLayer(cfg, dtype=self.dtype, name=f"layer_{i}")(
                x, image_embeds, self_mask
            )
        return x


class ImageReward(nn.Module):
    """BLIP backbone + activation-free MLP reward head, standardized."""

    cfg: BlipConfig
    mean: float = 0.16717362830052426   # ImageReward-v1.0 constants
    std: float = 1.0333394966054072
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"

    def setup(self):
        self.visual_encoder = BlipVisionTower(
            self.cfg.vision, dtype=self.dtype, attn_impl=self.attn_impl
        )
        self.text_encoder = BlipTextEncoder(self.cfg.text, dtype=self.dtype)
        dims = (1024, 128, 64, 16, 1)
        self.mlp_layers = [
            nn.Dense(d, dtype=self.dtype, name=f"mlp_{i}")
            for i, d in enumerate(dims)
        ]

    def __call__(
        self,
        pixel_values: jax.Array,       # [B, S, S, 3]
        input_ids: jax.Array,          # [B, L]
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Standardized reward scores [B]."""
        image_embeds = self.visual_encoder(pixel_values)
        hidden = self.text_encoder(input_ids, image_embeds, attention_mask)
        x = hidden[:, 0]
        for layer in self.mlp_layers:
            x = layer(x)
        return (x[:, 0] - self.mean) / self.std


def convert_blip_vision_state_dict(
    sd: Mapping[str, Any], prefix: str = "blip.visual_encoder."
) -> Dict[str, Any]:
    """Original-BLIP / timm ViT layout -> BlipVisionTower params."""
    import numpy as np

    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    conv_w = _np(sd["patch_embed.proj.weight"])
    width, cin, p, _ = conv_w.shape
    n = 0
    while f"blocks.{n}.norm1.weight" in sd:
        n += 1
    blocks: Dict[str, Any] = {}
    for i in range(n):
        pre = f"blocks.{i}"
        blocks[f"resblocks_{i}"] = {
            "ln_1": _layernorm(sd, f"{pre}.norm1"),
            "attn": {
                "in_proj": _linear(sd, f"{pre}.attn.qkv"),
                "out_proj": _linear(sd, f"{pre}.attn.proj"),
            },
            "ln_2": _layernorm(sd, f"{pre}.norm2"),
            "mlp": {
                "c_fc": _linear(sd, f"{pre}.mlp.fc1"),
                "c_proj": _linear(sd, f"{pre}.mlp.fc2"),
            },
        }
    return {
        "patch_embed": {
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width),
            "bias": _np(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd["cls_token"]).reshape(-1),
        "pos_embed": _np(sd["pos_embed"]).reshape(-1, width),
        "blocks": blocks,
        "norm": _layernorm(sd, "norm"),
    }


def convert_med_text_state_dict(
    sd: Mapping[str, Any], prefix: str = "blip.text_encoder."
) -> Dict[str, Any]:
    """med BertModel layout (attention.self.query etc.) ->
    BlipTextEncoder params."""
    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items()
              if k.startswith("bert.")}

    def med_attn(pre: str) -> Dict[str, Any]:
        return {
            "query": _linear(sd, f"{pre}.self.query"),
            "key": _linear(sd, f"{pre}.self.key"),
            "value": _linear(sd, f"{pre}.self.value"),
            "out_dense": _linear(sd, f"{pre}.output.dense"),
            "out_ln": _layernorm(sd, f"{pre}.output.LayerNorm"),
        }

    n = 0
    while f"encoder.layer.{n}.attention.self.query.weight" in sd:
        n += 1
    params: Dict[str, Any] = {
        "word_embeddings": {
            "embedding": _np(sd["embeddings.word_embeddings.weight"])
        },
        "position_embeddings": {
            "embedding": _np(sd["embeddings.position_embeddings.weight"])
        },
        "embeddings_ln": _layernorm(sd, "embeddings.LayerNorm"),
    }
    for i in range(n):
        pre = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": med_attn(f"{pre}.attention"),
            "crossattention": med_attn(f"{pre}.crossattention"),
            "ffn": {
                "intermediate": _linear(sd, f"{pre}.intermediate.dense"),
                "output": _linear(sd, f"{pre}.output.dense"),
                "ln": _layernorm(sd, f"{pre}.output.LayerNorm"),
            },
        }
    return params


def convert_image_reward_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """THUDM ImageReward checkpoint -> ImageReward params. MLP keys:
    mlp.layers.{0,2,4,6,7} (dropouts at 1/3/5 are parameterless)."""
    from ..core.torch_convert import _linear

    sd = dict(sd)
    params: Dict[str, Any] = {
        "visual_encoder": convert_blip_vision_state_dict(sd),
        "text_encoder": convert_med_text_state_dict(sd),
    }
    for i, idx in enumerate((0, 2, 4, 6, 7)):
        params[f"mlp_{i}"] = _linear(sd, f"mlp.layers.{idx}")
    return params
