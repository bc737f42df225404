"""Swin Transformer vision tower (timm swin_transformer.py) for CLIP.

Reference: open_clip model_configs/swin_base_patch4_window7_224.json routes
the vision side through timm (pool '', proj 'linear') wrapped by TimmModel —
trunk keeps its default avg pooling, head = Linear(1024, embed_dim,
bias=False).

Swin-B (Liu et al., ICCV 2021; timm layout):
  patch_embed: conv4x4 s4 -> LN                        (dims[0] = 128)
  4 stages with depths (2, 2, 18, 2), heads (4, 8, 16, 32); each block is
  LN -> windowed MSA (7x7 windows, relative position bias, alternate blocks
  shifted by 3 with the wrap-around attention mask) -> res -> LN -> 4x GELU
  MLP -> res. Between stages: PatchMerging (2x2 concat -> LN -> bias-less
  Linear 4C->2C).
  final LN -> global average pool over tokens.

Converter consumes the open_clip CustomTextCLIP layout ``visual.trunk.*``
(timm keys layers.N.blocks.M.*, layers.N.downsample.*) + ``visual.head``.
Parity vs a torch replica in tests/test_swin.py (timm absent here).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

Dtype = Any
LN_EPS = 1e-5  # torch nn.LayerNorm default (swin uses the default)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    image_size: int = 224
    patch_size: int = 4
    embed_dim: int = 128                      # stage-0 width (Swin-B)
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    heads: Tuple[int, ...] = (4, 8, 16, 32)
    window: int = 7
    mlp_ratio: float = 4.0
    out_dim: int = 640                        # CLIP projection dim

    @property
    def num_features(self) -> int:
        return self.embed_dim * 2 ** (len(self.depths) - 1)


def relative_position_index(window: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 bias table (timm/swin layout)."""
    coords = np.stack(np.meshgrid(
        np.arange(window), np.arange(window), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]          # [2, ww, ww]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def _window_partition(x: jax.Array, w: int) -> jax.Array:
    """[B, H, W, C] -> [B*nW, w*w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(x: jax.Array, w: int, h: int, ww: int) -> jax.Array:
    b = x.shape[0] // (h // w * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Wrap-around mask for SW-MSA: [nW, w*w, w*w] additive (0 / -100)."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    windows = np.asarray(_window_partition(jnp.asarray(img), window))
    windows = windows.reshape(-1, window * window)
    mask = windows[:, None, :] - windows[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class SwinBlock(nn.Module):
    heads: int
    window: int
    shift: int
    mlp_ratio: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, h, w, d = x.shape
        win = self.window
        hd = d // self.heads
        shortcut = x
        hnorm = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                             name="norm1")(x)
        if self.shift:
            hnorm = jnp.roll(hnorm, (-self.shift, -self.shift), axis=(1, 2))
        windows = _window_partition(hnorm, win)      # [B*nW, ww, d]
        nwin, ww, _ = windows.shape
        qkv = nn.Dense(3 * d, use_bias=True, dtype=self.dtype,
                       name="qkv")(windows)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def split_heads(t):
            return t.reshape(nwin, ww, self.heads, hd).transpose(0, 2, 1, 3)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        s = jnp.einsum("whqd,whkd->whqk", q, k,
                       preferred_element_type=jnp.float32) * (hd ** -0.5)

        table = self.param(
            "relative_position_bias_table",
            nn.initializers.normal(0.02),
            ((2 * win - 1) ** 2, self.heads),
        )
        index = relative_position_index(win).reshape(-1)
        bias = table[index].reshape(ww, ww, self.heads)
        s = s + bias.transpose(2, 0, 1)[None].astype(jnp.float32)

        if self.shift:
            amask = jnp.asarray(
                _shift_attn_mask(h, w, win, self.shift))   # [nW, ww, ww]
            nw = amask.shape[0]
            s = s.reshape(nwin // nw, nw, self.heads, ww, ww)
            s = s + amask[None, :, None]
            s = s.reshape(nwin, self.heads, ww, ww)

        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        o = jnp.einsum("whqk,whkd->whqd", p, v)
        o = o.transpose(0, 2, 1, 3).reshape(nwin, ww, d)
        o = nn.Dense(d, dtype=self.dtype, name="attn_proj")(o)
        o = _window_reverse(o, win, h, w)
        if self.shift:
            o = jnp.roll(o, (self.shift, self.shift), axis=(1, 2))
        x = shortcut + o

        hnorm = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                             name="norm2")(x)
        m = nn.Dense(int(d * self.mlp_ratio), dtype=self.dtype,
                     name="fc1")(hnorm)
        m = nn.gelu(m, approximate=False)
        x = x + nn.Dense(d, dtype=self.dtype, name="fc2")(m)
        return x


class PatchMerging(nn.Module):
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, h, w, c = x.shape
        x0 = x[:, 0::2, 0::2]
        x1 = x[:, 1::2, 0::2]
        x2 = x[:, 0::2, 1::2]
        x3 = x[:, 1::2, 1::2]
        x = jnp.concatenate([x0, x1, x2, x3], axis=-1)  # [B, H/2, W/2, 4C]
        x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm")(x)
        return nn.Dense(2 * c, use_bias=False, dtype=self.dtype,
                        name="reduction")(x)


class SwinTower(nn.Module):
    cfg: SwinConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        p = cfg.patch_size
        x = images.astype(self.dtype)
        b, hh, ww_, _ = x.shape
        x = x.reshape(b, hh // p, p, ww_ // p, p, 3)
        x = x.transpose(0, 1, 3, 2, 4, 5).reshape(
            b, hh // p, ww_ // p, p * p * 3)
        x = nn.Dense(cfg.embed_dim, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                         name="patch_norm")(x)

        block = SwinBlock
        if self.remat:
            block = nn.remat(SwinBlock)
        for stage, (depth, heads) in enumerate(zip(cfg.depths, cfg.heads)):
            for i in range(depth):
                shift = 0 if i % 2 == 0 else cfg.window // 2
                x = block(
                    heads, cfg.window, shift, cfg.mlp_ratio,
                    dtype=self.dtype, name=f"stage{stage}_block{i}",
                )(x)
            if stage < len(cfg.depths) - 1:
                x = PatchMerging(dtype=self.dtype,
                                 name=f"downsample{stage}")(x)

        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype,
                              name="norm")(tokens)
        pooled = tokens.mean(axis=1)
        pooled = nn.Dense(cfg.out_dim, use_bias=False, dtype=self.dtype,
                          name="head_proj")(pooled)
        return pooled, tokens


def convert_swin_trunk_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip swin checkpoint (visual.trunk.* timm layout + visual.head)
    -> SwinTower params."""
    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    conv_w = _np(sd["trunk.patch_embed.proj.weight"])  # [C, 3, p, p]
    c, cin, p, _ = conv_w.shape
    params: Dict[str, Any] = {
        "patch_embed": {
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, c),
            "bias": _np(sd["trunk.patch_embed.proj.bias"]),
        },
        "patch_norm": _layernorm(sd, "trunk.patch_embed.norm"),
        "norm": _layernorm(sd, "trunk.norm"),
        "head_proj": {"kernel": _np(sd["head.proj.weight"]).T},
    }
    stage = 0
    while f"trunk.layers.{stage}.blocks.0.norm1.weight" in sd:
        i = 0
        while f"trunk.layers.{stage}.blocks.{i}.norm1.weight" in sd:
            pre = f"trunk.layers.{stage}.blocks.{i}"
            params[f"stage{stage}_block{i}"] = {
                "norm1": _layernorm(sd, pre + ".norm1"),
                "qkv": _linear(sd, pre + ".attn.qkv"),
                "attn_proj": _linear(sd, pre + ".attn.proj"),
                "relative_position_bias_table": _np(
                    sd[pre + ".attn.relative_position_bias_table"]),
                "norm2": _layernorm(sd, pre + ".norm2"),
                "fc1": _linear(sd, pre + ".mlp.fc1"),
                "fc2": _linear(sd, pre + ".mlp.fc2"),
            }
            i += 1
        if f"trunk.layers.{stage}.downsample.norm.weight" in sd:
            params[f"downsample{stage}"] = {
                "norm": _layernorm(sd, f"trunk.layers.{stage}.downsample.norm"),
                "reduction": {
                    "kernel": _np(
                        sd[f"trunk.layers.{stage}.downsample.reduction.weight"]
                    ).T,
                },
            }
        stage += 1
    return params
