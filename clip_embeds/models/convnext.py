"""ConvNeXt CLIP vision tower (flax.linen, NHWC).

Reference: the open_clip fork routes convnext_* model configs through timm
(`timm_model_name: convnext_*`, open_clip/src/open_clip/timm_model.py:23-103;
model_configs/convnext_*.json) with `timm_pool: ''` (trunk's default global
average pool) and `timm_proj: linear|mlp` head. This is a native
re-implementation of that stack — timm ConvNeXt trunk semantics:

  stem:   Conv 4x4 stride 4 -> LayerNorm(channels)
  stage i (i>0 prefixed by downsample LayerNorm -> Conv 2x2 stride 2):
      block: depthwise Conv 7x7 (pad 3) -> LN -> Dense 4x -> GELU -> Dense
             -> layer-scale gamma -> residual
  head:   global avg pool -> LayerNorm -> proj
             proj 'linear': Dense(embed_dim, no bias)
             proj 'mlp':    Dense(2*embed) -> GELU -> Dense(embed, no bias)
                            (open_clip timm_model.py:97-101)

All norms eps 1e-6. Layout is NHWC throughout; the converter
transposes the NCHW torch kernels. Checkpoint layout matches open_clip's
``visual.trunk.*`` / ``visual.head.*`` keys (laion CLIP-convnext releases).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

from .layers import exact_gelu

Dtype = Any

# timm trunk shapes for the reference's convnext configs
CONVNEXT_SHAPES: Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]] = {
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "convnext_xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
    "convnext_xxlarge": ((3, 4, 30, 3), (384, 768, 1536, 3072)),
}


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 27, 3)
    dims: Tuple[int, ...] = (128, 256, 512, 1024)
    embed_dim: int = 640
    proj: str = "linear"  # 'linear' | 'mlp' (timm_proj)
    image_size: int = 256


class ConvNeXtBlock(nn.Module):
    dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:  # [B, H, W, C]
        h = nn.Conv(
            self.dim, (7, 7), padding=3, feature_group_count=self.dim,
            dtype=self.dtype, name="conv_dw",
        )(x)
        h = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm")(h)
        h = nn.Dense(4 * self.dim, dtype=self.dtype, name="fc1")(h)
        h = exact_gelu(h)
        h = nn.Dense(self.dim, dtype=self.dtype, name="fc2")(h)
        gamma = self.param(
            "gamma", nn.initializers.constant(1e-6), (self.dim,)
        )
        return x + gamma.astype(self.dtype) * h


class ConvNeXtTower(nn.Module):
    cfg: ConvNeXtConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """images [B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, HW, C])
        — tokens are the final-stage spatial features (pre-pool), matching
        the (pooled, tokens) tower convention used by CLIP.encode_image."""
        cfg = self.cfg
        x = images.astype(self.dtype)
        x = nn.Conv(
            cfg.dims[0], (4, 4), strides=4, padding=0, dtype=self.dtype,
            name="stem_conv",
        )(x)
        x = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="stem_norm")(x)

        block_cls = ConvNeXtBlock
        if self.remat:
            block_cls = nn.remat(ConvNeXtBlock)
        for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
            if si > 0:
                x = nn.LayerNorm(
                    epsilon=1e-6, dtype=self.dtype, name=f"down_norm_{si}"
                )(x)
                x = nn.Conv(
                    dim, (2, 2), strides=2, padding=0, dtype=self.dtype,
                    name=f"down_conv_{si}",
                )(x)
            for bi in range(depth):
                x = block_cls(dim, dtype=self.dtype,
                              name=f"stage_{si}_block_{bi}")(x)

        b, hh, ww, c = x.shape
        tokens = x.reshape(b, hh * ww, c)
        x = jnp.mean(x, axis=(1, 2))  # trunk default global avg pool
        x = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="head_norm")(x)
        if cfg.proj == "linear":
            x = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                         name="proj")(x)
        elif cfg.proj == "mlp":
            x = nn.Dense(2 * cfg.embed_dim, dtype=self.dtype,
                         name="proj_fc1")(x)
            x = exact_gelu(x)
            x = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                         name="proj_fc2")(x)
        else:
            raise ValueError(f"unknown proj {cfg.proj!r}")
        return x, tokens


def _np(t) -> np.ndarray:
    return np.asarray(getattr(t, "detach", lambda: t)().cpu()) \
        if hasattr(t, "detach") else np.asarray(t)


def _ln(sd, pre):
    return {"scale": _np(sd[pre + ".weight"]), "bias": _np(sd[pre + ".bias"])}


def _conv(sd, pre):
    # torch [O, I, kh, kw] -> flax [kh, kw, I, O]
    out = {"kernel": _np(sd[pre + ".weight"]).transpose(2, 3, 1, 0)}
    if pre + ".bias" in sd:
        out["bias"] = _np(sd[pre + ".bias"])
    return out


def _lin(sd, pre):
    out = {"kernel": _np(sd[pre + ".weight"]).T}
    if pre + ".bias" in sd:
        out["bias"] = _np(sd[pre + ".bias"])
    return out


def convert_convnext_tower(
    sd: Mapping[str, Any], cfg: ConvNeXtConfig, prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip ``visual.trunk.* / visual.head.*`` -> ConvNeXtTower params."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {
        "stem_conv": _conv(sd, "trunk.stem.0"),
        "stem_norm": _ln(sd, "trunk.stem.1"),
        "head_norm": _ln(sd, "trunk.head.norm"),
    }
    for si, depth in enumerate(cfg.depths):
        if si > 0:
            params[f"down_norm_{si}"] = _ln(
                sd, f"trunk.stages.{si}.downsample.0"
            )
            params[f"down_conv_{si}"] = _conv(
                sd, f"trunk.stages.{si}.downsample.1"
            )
        for bi in range(depth):
            pre = f"trunk.stages.{si}.blocks.{bi}"
            dw = _np(sd[pre + ".conv_dw.weight"])  # [C, 1, 7, 7]
            params[f"stage_{si}_block_{bi}"] = {
                # depthwise torch [C,1,kh,kw] -> flax [kh,kw,1,C]
                "conv_dw": {
                    "kernel": dw.transpose(2, 3, 1, 0),
                    "bias": _np(sd[pre + ".conv_dw.bias"]),
                },
                "norm": _ln(sd, pre + ".norm"),
                "fc1": _lin(sd, pre + ".mlp.fc1"),
                "fc2": _lin(sd, pre + ".mlp.fc2"),
                "gamma": _np(sd[pre + ".gamma"]),
            }
    if cfg.proj == "linear":
        params["proj"] = _lin(sd, "head.proj")
    else:
        params["proj_fc1"] = _lin(sd, "head.mlp.fc1")
        params["proj_fc2"] = _lin(sd, "head.mlp.fc2")
    return params
