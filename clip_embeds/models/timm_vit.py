"""Plain timm VisionTransformer towers for timm-named CLIP configs.

Covers open_clip configs whose vision side is a stock timm ViT wrapped by
TimmModel with pool '' and proj 'linear' (timm_model.py:52-105: trunk keeps
its default pooling, head = Linear(num_features, embed_dim, bias=False)):

  vit_medium_patch16_gap_256 — width 512, depth 12, heads 8, NO class token,
  global average pool with post-pool fc_norm (timm use_fc_norm), learned
  pos embed over the 16x16 patch grid, biased conv patchify, standard
  pre-LN blocks (fused qkv with bias, GELU MLP, LN eps 1e-6).

The structure intentionally mirrors timm's key layout (patch_embed.proj,
pos_embed, blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2},
fc_norm) so the converter is a direct mapping.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from .vit import patchify

Dtype = Any
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class TimmViTConfig:
    image_size: int = 256
    patch_size: int = 16
    width: int = 512
    depth: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    class_token: bool = False
    pool: str = "avg"          # 'avg' | 'token'
    fc_norm: bool = True       # LN after pooling (timm use_fc_norm)
    embed_dim: int = 512       # CLIP projection dim


TIMM_VIT_SHAPES = {
    "vit_medium_patch16_gap_256": TimmViTConfig(),
}


class TimmViTBlock(nn.Module):
    heads: int
    mlp_ratio: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, n, d = x.shape
        hd = d // self.heads
        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm1")(x)
        qkv = nn.Dense(3 * d, use_bias=True, dtype=self.dtype, name="qkv")(h)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def split_heads(t):
            return t.reshape(b, n, self.heads, hd).transpose(0, 2, 1, 3)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                       preferred_element_type=jnp.float32) * (hd ** -0.5)
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        o = jnp.einsum("bhqk,bhkd->bhqd", p, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, d)
        x = x + nn.Dense(d, dtype=self.dtype, name="attn_proj")(o)
        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm2")(x)
        h = nn.Dense(int(d * self.mlp_ratio), dtype=self.dtype,
                     name="fc1")(h)
        h = nn.gelu(h, approximate=False)
        x = x + nn.Dense(d, dtype=self.dtype, name="fc2")(h)
        return x


class TimmViTTower(nn.Module):
    cfg: TimmViTConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        b = images.shape[0]
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        if cfg.class_token:
            cls = self.param("cls_token", nn.initializers.normal(0.02),
                             (cfg.width,))
            x = jnp.concatenate(
                [jnp.broadcast_to(cls.astype(self.dtype),
                                  (b, 1, cfg.width)), x], axis=1)
        pos = self.param("pos_embed", nn.initializers.normal(0.02),
                         (x.shape[1], cfg.width))
        x = x + pos.astype(self.dtype)
        block = TimmViTBlock
        if self.remat:
            block = nn.remat(TimmViTBlock)
        for i in range(cfg.depth):
            x = block(cfg.heads, cfg.mlp_ratio, dtype=self.dtype,
                      name=f"blocks_{i}")(x)
        if not cfg.fc_norm:
            x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm")(x)
        tokens = x[:, 1:] if cfg.class_token else x
        if cfg.pool == "avg":
            pooled = tokens.mean(axis=1)
        else:
            pooled = x[:, 0]
        if cfg.fc_norm:
            pooled = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                                  name="fc_norm")(pooled)
        pooled = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                          name="head_proj")(pooled)
        return pooled, tokens


def convert_timm_vit_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip timm-ViT checkpoint (visual.trunk.* + visual.head.proj)
    -> TimmViTTower params."""
    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    conv_w = _np(sd["trunk.patch_embed.proj.weight"])  # [W, 3, p, p]
    width, cin, p, _ = conv_w.shape
    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin,
                                                           width),
            "bias": _np(sd["trunk.patch_embed.proj.bias"]),
        },
        "pos_embed": _np(sd["trunk.pos_embed"]).reshape(-1, width),
    }
    if "trunk.cls_token" in sd:
        params["cls_token"] = _np(sd["trunk.cls_token"]).reshape(-1)
    n = 0
    while f"trunk.blocks.{n}.norm1.weight" in sd:
        n += 1
    for i in range(n):
        pre = f"trunk.blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, pre + ".norm1"),
            "qkv": _linear(sd, pre + ".attn.qkv"),
            "attn_proj": _linear(sd, pre + ".attn.proj"),
            "norm2": _layernorm(sd, pre + ".norm2"),
            "fc1": _linear(sd, pre + ".mlp.fc1"),
            "fc2": _linear(sd, pre + ".mlp.fc2"),
        }
    if "trunk.norm.weight" in sd:
        params["norm"] = _layernorm(sd, "trunk.norm")
    if "trunk.fc_norm.weight" in sd:
        params["fc_norm"] = _layernorm(sd, "trunk.fc_norm")
    params["head_proj"] = {"kernel": _np(sd["head.proj.weight"]).T}
    return params
