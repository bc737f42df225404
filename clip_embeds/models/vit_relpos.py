"""Relative-position ViT tower (timm vit_relpos_medium_patch16_cls_224).

Backs the open_clip config ``vit_relpos_medium_patch16_cls_224.json``
(reference open_clip/src/open_clip/model_configs/, wrapped by
timm_model.py:52-105 with pool '' / proj 'linear': the trunk keeps its
default 'token' pooling and the head is Linear(512, 512, bias=False)).

Architecture per timm vision_transformer_relpos.py (timm is not installed
in this image; structure and key layout reconstructed from the published
model — the converter consumes the timm ``visual.trunk.*`` naming and the
torch replica in tests/test_vit_relpos.py encodes the same contract):

* patchify conv (k16 s16, bias), class token, NO absolute pos embed
* every block carries its own RelPosMlp ('cr' mode): a 2->256->heads ReLU
  MLP over sign(c)*log1p(|c|) relative coords, gathered into an (N,N)
  per-head additive attention bias, zero-padded for the 1 prefix (cls) row
  and column
* pre-LN blocks with bias-less fused qkv, LayerScale (ls1/ls2) on both
  residual branches, GELU MLP
* final LN ('norm'), token pooling (x[:, 0]), linear projection head

The relative-coords table and gather index are static functions of the
patch grid, computed host-side at trace time (XLA sees constants).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

from .vit import patchify

Dtype = Any
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class RelPosViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 512
    depth: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    rel_pos_hidden: int = 256  # timm rel_pos_dim
    layer_scale_init: float = 1e-6
    embed_dim: int = 512


RELPOS_VIT_SHAPES = {
    "vit_relpos_medium_patch16_cls_224": RelPosViTConfig(),
}


def rel_log_coords(grid: int) -> np.ndarray:
    """timm gen_relative_log_coords mode='cr': sign(c) * log1p(|c|)."""
    r = np.arange(-(grid - 1), grid, dtype=np.float32)
    coords = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    return np.sign(coords) * np.log1p(np.abs(coords))  # (2g-1, 2g-1, 2)


def rel_position_index(grid: int) -> np.ndarray:
    """timm gen_relative_position_index: (N, N) gather index into the
    flattened (2g-1)*(2g-1) relative-distance table."""
    coords = np.stack(
        np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    ).reshape(2, -1)  # (2, N)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += grid - 1
    rel[..., 1] += grid - 1
    rel[..., 0] *= 2 * grid - 1
    return rel.sum(-1)  # (N, N)


class RelPosBlock(nn.Module):
    heads: int
    mlp_ratio: float
    grid: int
    layer_scale_init: float
    rel_pos_hidden: int = 256
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, n, d = x.shape
        hd = d // self.heads

        # --- per-block relative-position bias (RelPosMlp, mode 'cr') ---
        table = jnp.asarray(rel_log_coords(self.grid))  # (2g-1, 2g-1, 2)
        hcoord = nn.Dense(self.rel_pos_hidden, name="rel_fc1")(table)
        hcoord = nn.relu(hcoord)
        bias_tab = nn.Dense(self.heads, name="rel_fc2")(hcoord)
        bias_tab = bias_tab.reshape(-1, self.heads)
        idx = jnp.asarray(rel_position_index(self.grid).reshape(-1))
        bias = jnp.take(bias_tab, idx, axis=0)  # (N*N, heads)
        npatch = self.grid * self.grid
        bias = bias.reshape(npatch, npatch, self.heads).transpose(2, 0, 1)
        # zero bias for the cls prefix row/column (timm F.pad prefix_tokens)
        bias = jnp.pad(bias, ((0, 0), (1, 0), (1, 0)))
        bias = bias.astype(jnp.float32)

        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm1")(x)
        qkv = nn.Dense(3 * d, use_bias=False, dtype=self.dtype,
                       name="qkv")(h)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def split_heads(t):
            return t.reshape(b, n, self.heads, hd).transpose(0, 2, 1, 3)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                       preferred_element_type=jnp.float32) * (hd ** -0.5)
        s = s + bias[None]
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        o = jnp.einsum("bhqk,bhkd->bhqd", p, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, d)
        o = nn.Dense(d, dtype=self.dtype, name="attn_proj")(o)
        ls1 = self.param("ls1", nn.initializers.constant(
            self.layer_scale_init), (d,))
        x = x + o * ls1.astype(self.dtype)

        h = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm2")(x)
        h = nn.Dense(int(d * self.mlp_ratio), dtype=self.dtype,
                     name="fc1")(h)
        h = nn.gelu(h, approximate=False)
        h = nn.Dense(d, dtype=self.dtype, name="fc2")(h)
        ls2 = self.param("ls2", nn.initializers.constant(
            self.layer_scale_init), (d,))
        return x + h * ls2.astype(self.dtype)


class RelPosViTTower(nn.Module):
    cfg: RelPosViTConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        b = images.shape[0]
        grid = cfg.image_size // cfg.patch_size
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        cls = self.param("cls_token", nn.initializers.normal(0.02),
                         (cfg.width,))
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1)
        block = RelPosBlock
        if self.remat:
            block = nn.remat(RelPosBlock)
        for i in range(cfg.depth):
            x = block(cfg.heads, cfg.mlp_ratio, grid,
                      cfg.layer_scale_init, cfg.rel_pos_hidden,
                      dtype=self.dtype, name=f"blocks_{i}")(x)
        x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm")(x)
        pooled = x[:, 0]
        tokens = x[:, 1:]
        pooled = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                          name="head_proj")(pooled)
        return pooled, tokens


def convert_relpos_vit_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip timm relpos-ViT checkpoint (visual.trunk.* per timm
    vision_transformer_relpos naming + visual.head.proj) -> tower params."""
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
        "cls_token": _np(sd["trunk.cls_token"]).reshape(-1),
    }
    n = 0
    while f"trunk.blocks.{n}.norm1.weight" in sd:
        n += 1
    for i in range(n):
        pre = f"trunk.blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, pre + ".norm1"),
            "qkv": _linear(sd, pre + ".attn.qkv"),
            "attn_proj": _linear(sd, pre + ".attn.proj"),
            "rel_fc1": _linear(sd, pre + ".attn.rel_pos.mlp.fc1"),
            "rel_fc2": _linear(sd, pre + ".attn.rel_pos.mlp.fc2"),
            "ls1": _np(sd[pre + ".ls1.gamma"]),
            "norm2": _layernorm(sd, pre + ".norm2"),
            "fc1": _linear(sd, pre + ".mlp.fc1"),
            "fc2": _linear(sd, pre + ".mlp.fc2"),
            "ls2": _np(sd[pre + ".ls2.gamma"]),
        }
    params["norm"] = _layernorm(sd, "trunk.norm")
    params["head_proj"] = {"kernel": _np(sd["head.proj.weight"]).T}
    return params
