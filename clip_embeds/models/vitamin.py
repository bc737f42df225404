"""ViTamin vision tower (timm vitamin.py) for the ViTamin-* CLIP configs.

Reference: open_clip model_configs/ViTamin-*.json route the vision side
through timm (timm_model_name vitamin_{small,base,large,large2,xlarge}_*,
pool '', proj 'linear') wrapped by TimmModel (timm_model.py:52-105: with an
extra linear proj the trunk keeps its default avg pooling and the head is
Dropout + Linear(num_features, embed_dim, bias=False)).

Architecture (timm vitamin.py, "ViTamin: Designing Scalable Vision Models
in the Vision-Language Era", CVPR 2024) — a 3-stage hybrid:

  stem:    conv3x3 s2 -> LN+GELU -> conv3x3 s1                (stride 2)
  stage 1: MbConvLN blocks x d1 (first block stride 2)        (stride 4)
  stage 2: MbConvLN blocks x d2 (first block stride 2)        (stride 8)
  to-ViT:  LN -> conv3x3 s2 (StridedConv "patchify")          (stride 16)
  stage 3: ViT blocks with fused-qkv attention and a GeGLU MLP
           (LN -> gelu(w0(x)) * w1(x) -> w2, hidden = 2*width),
           learned pos embed over the patch grid, NO class token
  pool:    mean over tokens -> fc_norm LayerNorm -> linear proj

MbConvLN block: pre-LN -> 1x1 expand (r=4) -> GELU -> 3x3 depthwise
(stride on the dw conv) -> GELU -> 1x1 project, residual via identity /
1x1 conv / (avg-pool-3x3-s2 + 1x1) when striding. All LayerNorms eps 1e-6,
channels-last here (timm's LayerNorm2d is the channels-first spelling).

Conversion consumes the open_clip checkpoint layout
``visual.trunk.patch_embed.backbone.*`` + ``visual.trunk.{pos_embed,blocks,
fc_norm}`` + ``visual.head.proj`` (CustomTextCLIP; text side is the
standard tower). Parity is tested against a torch replica of the same
block math in tests/test_vitamin.py (timm is not installed in this image).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

Dtype = Any

LN_EPS = 1e-6

# timm_model_name -> (mbconv dims (c1, c2), mbconv depths, vit width,
#                     vit depth, vit heads)
VITAMIN_SHAPES = {
    "vitamin_small": ((64, 128), (2, 4), 384, 14, 6),
    "vitamin_base": ((128, 256), (2, 4), 768, 14, 12),
    "vitamin_large": ((160, 320), (2, 4), 1024, 31, 16),
    "vitamin_large2": ((160, 320), (2, 4), 1024, 31, 16),
    "vitamin_xlarge": ((192, 384), (2, 4), 1152, 32, 16),
}


@dataclasses.dataclass(frozen=True)
class VitaminConfig:
    image_size: int = 224
    mbconv_dims: Tuple[int, int] = (160, 320)
    mbconv_depths: Tuple[int, int] = (2, 4)
    width: int = 1024          # stage-3 / token dim
    depth: int = 31
    heads: int = 16
    mlp_ratio: float = 2.0     # GeGLU hidden = width * mlp_ratio
    embed_dim: int = 768       # CLIP projection dim

    @property
    def grid_size(self) -> int:
        return self.image_size // 16


def vitamin_config(timm_name: str, image_size: int,
                   embed_dim: int) -> VitaminConfig:
    base = "_".join(timm_name.split("_")[:2])  # vitamin_<scale>
    dims, depths, width, depth, heads = VITAMIN_SHAPES[base]
    return VitaminConfig(
        image_size=image_size, mbconv_dims=dims, mbconv_depths=depths,
        width=width, depth=depth, heads=heads, embed_dim=embed_dim,
    )


def _conv(features, kernel, stride, groups=1, name=None):
    pad = (kernel - 1) // 2
    return nn.Conv(
        features, (kernel, kernel), strides=(stride, stride),
        padding=((pad, pad), (pad, pad)), feature_group_count=groups,
        use_bias=True, name=name,
    )


def _avg_pool_3x3_s2_exclude_pad(x: jax.Array) -> jax.Array:
    """AvgPool2d(3, stride 2, padding 1, count_include_pad=False)."""
    ones = jnp.ones(x.shape[:3] + (1,), x.dtype)
    sum_ = jax.lax.reduce_window(
        x, 0.0, jax.lax.add, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)],
    )
    count = jax.lax.reduce_window(
        ones, 0.0, jax.lax.add, (1, 3, 3, 1), (1, 2, 2, 1),
        [(0, 0), (1, 1), (1, 1), (0, 0)],
    )
    return sum_ / count


class MbConvLNBlock(nn.Module):
    out_chs: int
    stride: int = 1
    expand_ratio: float = 4.0
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        in_chs = x.shape[-1]
        mid = int(self.out_chs * self.expand_ratio)
        if self.stride == 2:
            shortcut = _avg_pool_3x3_s2_exclude_pad(x)
            if in_chs != self.out_chs:
                shortcut = nn.Conv(self.out_chs, (1, 1), use_bias=True,
                                   dtype=self.dtype,
                                   name="shortcut_expand")(shortcut)
        elif in_chs != self.out_chs:
            shortcut = nn.Conv(self.out_chs, (1, 1), use_bias=True,
                               dtype=self.dtype, name="shortcut")(x)
        else:
            shortcut = x
        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                         name="pre_norm")(x)
        h = _conv(mid, 1, 1, name="conv1_1x1")(h)
        h = nn.gelu(h, approximate=False)
        h = _conv(mid, 3, self.stride, groups=mid, name="conv2_kxk")(h)
        h = nn.gelu(h, approximate=False)
        h = _conv(self.out_chs, 1, 1, name="conv3_1x1")(h)
        return h + shortcut


class GeGluMlp(nn.Module):
    hidden: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        d = x.shape[-1]
        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm")(x)
        gate = nn.Dense(self.hidden, dtype=self.dtype, name="w0")(h)
        val = nn.Dense(self.hidden, dtype=self.dtype, name="w1")(h)
        h = nn.gelu(gate, approximate=False) * val
        return nn.Dense(d, dtype=self.dtype, name="w2")(h)


class VitaminVitBlock(nn.Module):
    heads: int
    mlp_ratio: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, n, d = x.shape
        hd = d // self.heads
        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm1")(x)
        qkv = nn.Dense(3 * d, use_bias=True, dtype=self.dtype,
                       name="qkv")(h)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def split_heads(t):
            return t.reshape(b, n, self.heads, hd).transpose(0, 2, 1, 3)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                       preferred_element_type=jnp.float32) * (hd ** -0.5)
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        o = jnp.einsum("bhqk,bhkd->bhqd", p, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, d)
        o = nn.Dense(d, use_bias=True, dtype=self.dtype, name="attn_proj")(o)
        x = x + o
        # timm Block applies norm2 before the mlp AND GeGluMlp carries its
        # own inner norm — real checkpoints have both
        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm2")(x)
        x = x + GeGluMlp(int(d * self.mlp_ratio), dtype=self.dtype,
                         name="mlp")(h)
        return x


class VitaminTower(nn.Module):
    """ViTamin trunk + CLIP head projection (pooled, tokens)."""

    cfg: VitaminConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        x = images.astype(self.dtype)
        c1, c2 = cfg.mbconv_dims

        # stem (stride 2)
        x = _conv(c1, 3, 2, name="stem_conv1")(x)
        x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                         name="stem_norm1")(x)
        x = nn.gelu(x, approximate=False)
        x = _conv(c1, 3, 1, name="stem_conv2")(x)

        # MbConv stages (each enters with a stride-2 block)
        for stage, (chs, depth) in enumerate(
                zip(cfg.mbconv_dims, cfg.mbconv_depths)):
            for i in range(depth):
                x = MbConvLNBlock(
                    chs, stride=2 if i == 0 else 1, dtype=self.dtype,
                    name=f"stage{stage}_block{i}",
                )(x)

        # StridedConv "patchify" to the ViT width (stride 2 -> total 16)
        x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                         name="pool_norm")(x)
        x = _conv(cfg.width, 3, 2, name="pool_proj")(x)

        b, h, w, d = x.shape
        x = x.reshape(b, h * w, d)
        pos = self.param("pos_embed", nn.initializers.normal(0.02),
                         (h * w, d))
        x = x + pos.astype(self.dtype)

        block = VitaminVitBlock
        if self.remat:
            block = nn.remat(VitaminVitBlock)
        for i in range(cfg.depth):
            x = block(cfg.heads, cfg.mlp_ratio, dtype=self.dtype,
                      name=f"blocks_{i}")(x)

        tokens = x
        pooled = x.mean(axis=1)
        pooled = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                              name="fc_norm")(pooled)
        pooled = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                          name="head_proj")(pooled)
        return pooled, tokens


def _t_conv(sd: Mapping[str, Any], key: str, depthwise: bool = False):
    from ..core.torch_convert import _np

    w = _np(sd[key + ".weight"])          # [out, in/groups, kh, kw]
    out = {"kernel": w.transpose(2, 3, 1, 0)}
    if key + ".bias" in sd:
        out["bias"] = _np(sd[key + ".bias"])
    return out


def convert_vitamin_trunk_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip ViTamin checkpoint (visual.trunk.* timm layout + visual.head)
    -> VitaminTower params."""
    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    bb = "trunk.patch_embed.backbone."
    params: Dict[str, Any] = {
        "stem_conv1": _t_conv(sd, bb + "stem.conv1"),
        "stem_norm1": _layernorm(sd, bb + "stem.norm1"),
        "stem_conv2": _t_conv(sd, bb + "stem.conv2"),
        "pool_norm": _layernorm(sd, bb + "pool.norm"),
        "pool_proj": _t_conv(sd, bb + "pool.proj"),
    }
    for stage in (0, 1):
        i = 0
        while f"{bb}stages.{stage}.{i}.pre_norm.weight" in sd:
            p = f"{bb}stages.{stage}.{i}"
            blk = {
                "pre_norm": _layernorm(sd, p + ".pre_norm"),
                "conv1_1x1": _t_conv(sd, p + ".conv1_1x1"),
                "conv2_kxk": _t_conv(sd, p + ".conv2_kxk", depthwise=True),
                "conv3_1x1": _t_conv(sd, p + ".conv3_1x1"),
            }
            if p + ".shortcut.weight" in sd:
                key = "shortcut_expand" if i == 0 else "shortcut"
                blk[key] = _t_conv(sd, p + ".shortcut")
            # timm names the stride-2 shortcut Downsample2d 'shortcut.expand'
            if p + ".shortcut.expand.weight" in sd:
                blk["shortcut_expand"] = _t_conv(sd, p + ".shortcut.expand")
            params[f"stage{stage}_block{i}"] = blk
            i += 1
    n = 0
    while f"trunk.blocks.{n}.norm1.weight" in sd:
        n += 1
    for i in range(n):
        p = f"trunk.blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, p + ".norm1"),
            "norm2": _layernorm(sd, p + ".norm2"),
            "qkv": _linear(sd, p + ".attn.qkv"),
            "attn_proj": _linear(sd, p + ".attn.proj"),
            "mlp": {
                "norm": _layernorm(sd, p + ".mlp.norm"),
                "w0": _linear(sd, p + ".mlp.w0"),
                "w1": _linear(sd, p + ".mlp.w1"),
                "w2": _linear(sd, p + ".mlp.w2"),
            },
        }
    params["pos_embed"] = _np(sd["trunk.pos_embed"]).reshape(
        -1, _np(sd["trunk.pos_embed"]).shape[-1])
    params["fc_norm"] = _layernorm(sd, "trunk.fc_norm")
    params["head_proj"] = {"kernel": _np(sd["head.proj.weight"]).T}
    return params
