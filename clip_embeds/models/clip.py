"""Dual-tower CLIP model (flax.linen).

Functional equivalent of the reference CLIP (open_clip/src/open_clip/model.py:
222-436): vision + text towers, learned temperature, normalized features.
The forward returns a dict like the reference's output_dict mode (model.py:
415-436).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import CLIPConfig
from .text_transformer import TextTransformer
from .vit import VisionTransformer

Dtype = Any

LOGIT_SCALE_MAX = 4.6052  # ln(100), clamp applied in the train step


def l2_normalize(x: jax.Array, axis: int = -1, eps: float = 1e-12) -> jax.Array:
    norm = jnp.linalg.norm(x, axis=axis, keepdims=True)
    return x / jnp.maximum(norm, eps)


class CLIP(nn.Module):
    cfg: CLIPConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant: bool = False  # int8 serving path (models/quant.py)
    scan_layers: bool = False  # lax.scan over blocks (small HLO, fast compile)

    def setup(self):
        if self.cfg.vision.tower == "resnet":
            from .resnet import ModifiedResNet

            self.visual = ModifiedResNet(
                layers=self.cfg.vision.resnet_layers,
                output_dim=self.cfg.embed_dim,
                heads=self.cfg.vision.width * 32 // 64,
                image_size=self.cfg.vision.image_size,
                width=self.cfg.vision.width,
                dtype=self.dtype,
            )
        elif self.cfg.vision.tower == "eva":
            from .eva import EVAVisionTower

            self.visual = EVAVisionTower(
                self.cfg.vision, self.cfg.embed_dim, dtype=self.dtype,
                attn_impl=self.attn_impl, remat=self.remat,
            )
        elif self.cfg.vision.tower == "eva02":
            from .eva import EVA02VisionTower

            self.visual = EVA02VisionTower(
                self.cfg.vision, self.cfg.embed_dim, dtype=self.dtype,
                attn_impl=self.attn_impl, remat=self.remat,
            )
        elif self.cfg.vision.tower == "timm-vit":
            from .timm_vit import TimmViTConfig, TimmViTTower

            v = self.cfg.vision
            self.visual = TimmViTTower(
                TimmViTConfig(
                    image_size=v.image_size, patch_size=v.patch_size,
                    width=v.width, depth=v.layers, heads=v.heads,
                    mlp_ratio=v.mlp_ratio,
                    class_token=(v.pool_type == "tok"),
                    pool=("token" if v.pool_type == "tok" else "avg"),
                    fc_norm=v.final_ln_after_pool,
                    embed_dim=self.cfg.embed_dim,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        elif self.cfg.vision.tower == "relpos-vit":
            from .vit_relpos import RelPosViTConfig, RelPosViTTower

            v = self.cfg.vision
            self.visual = RelPosViTTower(
                RelPosViTConfig(
                    image_size=v.image_size, patch_size=v.patch_size,
                    width=v.width, depth=v.layers, heads=v.heads,
                    mlp_ratio=v.mlp_ratio, embed_dim=self.cfg.embed_dim,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        elif self.cfg.vision.tower == "mci-vit":
            from .mci_vit import MCiViTConfig, MCiViTTower

            v = self.cfg.vision
            self.visual = MCiViTTower(
                MCiViTConfig(
                    image_size=v.image_size, width=v.width, depth=v.layers,
                    heads=v.width // v.head_width, mlp_ratio=v.mlp_ratio,
                    embed_dim=self.cfg.embed_dim,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        elif self.cfg.vision.tower == "swin":
            from .swin import SwinConfig, SwinTower

            v = self.cfg.vision
            self.visual = SwinTower(
                SwinConfig(
                    image_size=v.image_size, patch_size=v.patch_size,
                    embed_dim=v.width, depths=tuple(v.swin_depths),
                    heads=tuple(v.swin_heads), window=v.swin_window,
                    mlp_ratio=v.mlp_ratio, out_dim=self.cfg.embed_dim,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        elif self.cfg.vision.tower == "vitamin":
            from .vitamin import VitaminConfig, VitaminTower

            v = self.cfg.vision
            self.visual = VitaminTower(
                VitaminConfig(
                    image_size=v.image_size,
                    mbconv_dims=tuple(v.vitamin_mbconv_dims),
                    mbconv_depths=tuple(v.vitamin_mbconv_depths),
                    width=v.width, depth=v.layers, heads=v.heads,
                    mlp_ratio=v.mlp_ratio, embed_dim=self.cfg.embed_dim,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        elif self.cfg.vision.tower == "fastvit":
            from .fastvit import FastViTConfig, FastViTTower

            v = self.cfg.vision
            self.visual = FastViTTower(
                FastViTConfig(
                    image_size=v.image_size,
                    layers=tuple(v.fastvit_layers),
                    dims=tuple(v.fastvit_dims),
                    mlp_ratio=v.mlp_ratio,
                    embed_dim=self.cfg.embed_dim,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        elif self.cfg.vision.tower == "convnext":
            from .convnext import ConvNeXtConfig, ConvNeXtTower

            self.visual = ConvNeXtTower(
                ConvNeXtConfig(
                    depths=self.cfg.vision.convnext_depths,
                    dims=self.cfg.vision.convnext_dims,
                    embed_dim=self.cfg.embed_dim,
                    proj=self.cfg.vision.head_proj,
                    image_size=self.cfg.vision.image_size,
                ),
                dtype=self.dtype, remat=self.remat,
            )
        else:
            self.visual = VisionTransformer(
                self.cfg.vision, self.cfg.embed_dim, self.cfg.quick_gelu,
                dtype=self.dtype, attn_impl=self.attn_impl, remat=self.remat,
                quant=self.quant, scan_layers=self.scan_layers,
            )
        self.text = TextTransformer(
            self.cfg.text, self.cfg.embed_dim, self.cfg.quick_gelu,
            dtype=self.dtype, attn_impl=self.attn_impl, remat=self.remat,
            quant=self.quant, scan_layers=self.scan_layers,
        )
        self.logit_scale = self.param(
            "logit_scale",
            nn.initializers.constant(self.cfg.init_logit_scale),
            (),
        )
        if self.cfg.init_logit_bias is not None:
            self.logit_bias = self.param(
                "logit_bias",
                nn.initializers.constant(self.cfg.init_logit_bias),
                (),
            )
        else:
            self.logit_bias = None

    def encode_image(
        self, images: jax.Array, normalize: bool = False,
        output_tokens: bool = False, deterministic: bool = True,
    ):
        if not deterministic and self.cfg.vision.patch_dropout > 0.0 \
                and self.cfg.vision.tower == "vit":
            pooled, tokens = self.visual(images, deterministic=False)
        else:
            pooled, tokens = self.visual(images)
        if normalize:
            pooled = l2_normalize(pooled)
        return (pooled, tokens) if output_tokens else pooled

    def encode_text(
        self, text_ids: jax.Array, normalize: bool = False, output_tokens: bool = False
    ):
        pooled, tokens = self.text(text_ids)
        if normalize:
            pooled = l2_normalize(pooled)
        return (pooled, tokens) if output_tokens else pooled

    def __call__(
        self,
        images: Optional[jax.Array] = None,
        text_ids: Optional[jax.Array] = None,
        deterministic: bool = True,
    ) -> Dict[str, jax.Array]:
        out: Dict[str, jax.Array] = {"logit_scale": jnp.exp(self.logit_scale)}
        if images is not None:
            out["image_features"] = self.encode_image(
                images, normalize=True, deterministic=deterministic
            )
        if text_ids is not None:
            out["text_features"] = self.encode_text(text_ids, normalize=True)
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out

    def get_logits(self, images: jax.Array, text_ids: jax.Array):
        """(logits_per_image, logits_per_text) — reference model.py:322-330."""
        img = self.encode_image(images, normalize=True)
        txt = self.encode_text(text_ids, normalize=True)
        logits = jnp.exp(self.logit_scale) * img @ txt.T
        if self.logit_bias is not None:
            logits = logits + self.logit_bias
        return logits, logits.T


def stack_clip_params(params):
    """Unrolled CLIP params -> scan_layers layout (towers' blocks stacked)."""
    from .layers import stack_block_params

    out = dict(params)
    for tower in ("visual", "text"):
        if tower in out and "transformer" in out[tower]:
            t = dict(out[tower])
            t["transformer"] = stack_block_params(t["transformer"])
            out[tower] = t
    return out
