"""CustomTextCLIP: ViT vision tower + HF-style text tower.

Reference: open_clip's CustomTextCLIP (model.py:438-...) pairs any vision
tower with an HFTextEncoder (hf_model.py:96) for the roberta-/xlm-roberta-/
mt5-* model configs (e.g. model_configs/roberta-ViT-B-32.json: hf_model_name
+ mean_pooler + proj 'mlp'). Here the text side is one of the native towers
in models/hf_text.py (T5/mT5 encoder or post-LN BERT/RoBERTa) and the vision
side reuses models/vit.py. ``build_custom_text_clip`` resolves any of the
registry's hf-text archs into a ready model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .hf_text import BertTextConfig, BertTextTower, T5TextTower
from .t5 import T5Config
from .vit import VisionTransformer

Dtype = Any

# public shapes for the registry's hf_model_name text towers
HF_TEXT_SHAPES: Dict[str, Dict[str, Any]] = {
    "roberta-base": dict(
        kind="bert", vocab_size=50265, hidden_size=768, num_layers=12,
        num_heads=12, intermediate_size=3072, max_position_embeddings=514,
    ),
    "xlm-roberta-base": dict(
        kind="bert", vocab_size=250002, hidden_size=768, num_layers=12,
        num_heads=12, intermediate_size=3072, max_position_embeddings=514,
    ),
    "xlm-roberta-large": dict(
        kind="bert", vocab_size=250002, hidden_size=1024, num_layers=24,
        num_heads=16, intermediate_size=4096, max_position_embeddings=514,
    ),
    "google/mt5-base": dict(
        kind="t5", vocab_size=250112, d_model=768, d_kv=64, d_ff=2048,
        num_layers=12, num_heads=12,
    ),
    "google/mt5-xl": dict(
        kind="t5", vocab_size=250112, d_model=2048, d_kv=64, d_ff=5120,
        num_layers=24, num_heads=32,
    ),
    "facebook/nllb-200-distilled-600M": dict(
        kind="m2m100", vocab_size=256206, d_model=1024, num_layers=12,
        num_heads=16, ffn_dim=4096,
    ),
    "facebook/nllb-200-distilled-1.3B": dict(
        kind="m2m100", vocab_size=256206, d_model=2048, num_layers=24,
        num_heads=16, ffn_dim=8192,
    ),
}


@dataclasses.dataclass(frozen=True)
class CustomTextCLIPConfig:
    embed_dim: int
    vision: VisionConfig
    hf_model_name: str
    pooler: str = "mean"       # hf_pooler_type mean_pooler
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592
    init_logit_bias: Optional[float] = None  # SigLIP-style pairing bias
    # nllb-clip-*-siglip hybrids: SigLIP MAP-pooled vision trunk with
    # timm_proj 'none' (the MAP head output IS the embedding)
    siglip_vision: Optional[Any] = None      # models.siglip.SiglipVisionConfig


class CustomTextCLIP(nn.Module):
    cfg: CustomTextCLIPConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        cfg = self.cfg
        if cfg.siglip_vision is not None:
            from .siglip import SiglipVisionTower

            self.visual = SiglipVisionTower(
                cfg.siglip_vision, dtype=self.dtype,
                attn_impl=self.attn_impl,
            )
        else:
            self.visual = VisionTransformer(
                cfg.vision, cfg.embed_dim, cfg.quick_gelu, dtype=self.dtype,
                attn_impl=self.attn_impl, remat=self.remat,
            )
        shape = dict(HF_TEXT_SHAPES[cfg.hf_model_name])
        kind = shape.pop("kind")
        if kind == "t5":
            self.text = T5TextTower(
                T5Config(**shape), cfg.embed_dim, pooler=cfg.pooler,
                dtype=self.dtype,
            )
        elif kind == "m2m100":
            from .hf_text import M2M100Config, M2M100TextTower

            self.text = M2M100TextTower(
                M2M100Config(**shape), cfg.embed_dim, pooler=cfg.pooler,
                dtype=self.dtype,
            )
        else:
            self.text = BertTextTower(
                BertTextConfig(**shape), cfg.embed_dim, pooler=cfg.pooler,
                dtype=self.dtype,
            )
        self.logit_scale = self.param(
            "logit_scale",
            nn.initializers.constant(cfg.init_logit_scale), (),
        )
        if cfg.init_logit_bias is not None:
            self.logit_bias = self.param(
                "logit_bias",
                nn.initializers.constant(cfg.init_logit_bias), (),
            )
        else:
            self.logit_bias = None

    def encode_image(self, images: jax.Array, normalize: bool = False):
        out = self.visual(images)
        pooled = out[0] if isinstance(out, tuple) else out
        return l2_normalize(pooled) if normalize else pooled

    def encode_text(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        normalize: bool = False,
    ):
        pooled = self.text(input_ids, attention_mask)
        return l2_normalize(pooled) if normalize else pooled

    def __call__(
        self,
        images: Optional[jax.Array] = None,
        input_ids: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
    ) -> Dict[str, jax.Array]:
        out: Dict[str, jax.Array] = {
            "logit_scale": jnp.exp(self.logit_scale)
        }
        if images is not None:
            out["image_features"] = self.encode_image(images, normalize=True)
        if input_ids is not None:
            out["text_features"] = self.encode_text(
                input_ids, attention_mask, normalize=True
            )
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


def build_custom_text_clip(
    name: str, dtype: Any = jnp.float32, **kw
) -> CustomTextCLIP:
    """Resolve an hf-text registry arch (roberta-ViT-B-32, mt5-base-ViT-B-32,
    xlm-roberta-large-ViT-H-14, ...) into a CustomTextCLIP module."""
    from ..core.openclip_registry import classify_model, get_raw_model_config

    backend, detail = classify_model(name)
    if backend != "hf-text":
        raise NotImplementedError(f"{name!r} is not an hf-text config")
    raw = get_raw_model_config(name)
    v = raw["vision_cfg"]
    siglip_vision = None
    if v.get("timm_model_name", "").find("siglip") >= 0:
        # nllb-clip-*-siglip hybrid: SigLIP vision trunk (MAP pool, no proj)
        from ..core.openclip_registry import _parse_timm_siglip
        from .siglip import SiglipVisionConfig

        shape = _parse_timm_siglip(v["timm_model_name"])
        siglip_vision = SiglipVisionConfig(
            image_size=v.get("image_size", shape["image_size"]),
            patch_size=shape["patch_size"], width=shape["width"],
            layers=shape["layers"], heads=shape["heads"],
            intermediate_size=shape["intermediate_size"],
        )
        vision = VisionConfig()  # unused placeholder
    else:
        vision = VisionConfig(
            image_size=v.get("image_size", 224),
            patch_size=v.get("patch_size", 16),
            width=v.get("width", 768),
            layers=v.get("layers", 12),
            head_width=v.get("head_width", 64),
        )
    pooler = {
        "mean_pooler": "mean", "cls_pooler": "first",
    }.get(raw["text_cfg"].get("hf_pooler_type", "mean_pooler"), "mean")
    cfg = CustomTextCLIPConfig(
        embed_dim=raw["embed_dim"],
        vision=vision,
        hf_model_name=raw["text_cfg"]["hf_model_name"],
        pooler=pooler,
        quick_gelu=raw.get("quick_gelu", False),
        init_logit_bias=raw.get("init_logit_bias"),
        siglip_vision=siglip_vision,
    )
    return CustomTextCLIP(cfg, dtype=dtype, **kw)
