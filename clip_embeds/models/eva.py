"""EVA ViT tower (timm `eva_giant_patch14_224` family) for EVA01-g-14 CLIP.

Reference: open_clip/src/open_clip/model_configs/EVA01-g-14.json routes the
vision side through timm (timm_model_name eva_giant_patch14_224, pool
'token', proj null) wrapped by TimmModel (timm_model.py:58-66: with proj null
the timm classifier head Linear(width, embed_dim) IS the projection and the
trunk pools the CLS token). Architecture (timm eva.py, EVA-01 giant variant):

* biased conv patchify, prepended CLS token, learned abs pos-embed, NO ln_pre
* pre-norm blocks with BEiT-style fused qkv whose bias is
  [q_bias; zeros; v_bias] (k gets no bias), standard GELU MLP, LN eps 1e-6
* final LayerNorm `norm` -> CLS pool -> `head` linear to embed_dim

Shape for EVA01-g: width 1408, depth 40, heads 16, mlp 6144, patch 14 @ 224.
The converter consumes the open_clip `visual.trunk.*` checkpoint layout.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .layers import Transformer
from .vit import patchify

Dtype = Any


def eva_giant_config() -> VisionConfig:
    return VisionConfig(
        image_size=224, patch_size=14, width=1408, layers=40, head_width=88,
        mlp_ratio=6144 / 1408, tower="eva",
    )


class EVAVisionTower(nn.Module):
    cfg: VisionConfig
    embed_dim: int
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """[B, S, S, 3] -> (pooled [B, embed_dim], patch tokens [B, N, W])."""
        cfg = self.cfg
        b = images.shape[0]
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        cls = self.param(
            "cls_token", nn.initializers.normal(0.02), (cfg.width,)
        )
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1,
        )
        pos = self.param(
            "pos_embed", nn.initializers.normal(0.02),
            (x.shape[1], cfg.width),
        )
        x = x + pos.astype(self.dtype)
        x = Transformer(
            cfg.width, cfg.layers, cfg.heads, cfg.mlp_ratio,
            quick_gelu=False, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat, ln_eps=1e-6, name="blocks",
        )(x)
        x = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm")(x)
        pooled = nn.Dense(self.embed_dim, dtype=self.dtype, name="head")(
            x[:, 0]
        )
        return pooled, x[:, 1:]


# -- EVA02 ------------------------------------------------------------------
#
# timm eva.py EVA02 CLIP variants (model_configs/EVA02-*.json route through
# timm_model_name eva02_{base,large,enormous}_patch1x_clip_xxx):
#   base/large: split q/k/v projections (k bias-less), 2D rotary embedding on
#     q/k with the cls token excluded and coordinates rescaled to
#     ref_feat_shape (16, 16), LN on the concatenated attention output before
#     the out-projection, SwiGLU MLP (fc1_g/fc1_x -> SiLU gate -> LN -> fc2)
#     with hidden = int(width * 8/3), pre-norm blocks.
#   enormous: EVA01-style fused qkv ([q_bias; 0; v_bias]), plain GELU MLP,
#     post-norm blocks, no rope.


EVA02_SHAPES = {
    # timm_model_name -> (width, layers, head_width, mlp_ratio, variant)
    "eva02_base_patch16_clip_224": (768, 12, 64, 8 / 3, "swiglu"),
    "eva02_large_patch14_clip_224": (1024, 24, 64, 8 / 3, "swiglu"),
    "eva02_large_patch14_clip_336": (1024, 24, 64, 8 / 3, "swiglu"),
    "eva02_enormous_patch14_clip_224": (1792, 64, 112, 15360 / 1792, "post"),
}


def eva02_vision_config(timm_name: str, image_size: int) -> VisionConfig:
    width, layers, head_width, mlp_ratio, variant = EVA02_SHAPES[timm_name]
    patch = 16 if "patch16" in timm_name else 14
    if variant == "swiglu":
        return VisionConfig(
            image_size=image_size, patch_size=patch, width=width,
            layers=layers, head_width=head_width, mlp_ratio=mlp_ratio,
            tower="eva02", eva_rope=True, eva_swiglu=True,
            eva_attn_inner_norm=True, eva_ref_feat_shape=(16, 16),
        )
    return VisionConfig(
        image_size=image_size, patch_size=patch, width=width, layers=layers,
        head_width=head_width, mlp_ratio=mlp_ratio, tower="eva02",
        eva_post_norm=True,
    )


def eva02_rope_embed(
    grid: Tuple[int, int],
    head_dim: int,
    ref_shape: Tuple[int, int] = (),
    temperature: float = 10000.0,
):
    """(sin, cos) each [H*W, head_dim] — timm RotaryEmbeddingCat with
    in_pixels=False: per-axis integer coords (rescaled by ref_shape/grid),
    freq bands 1/T^(i/nb) with nb = head_dim//4, sin/cos repeated
    pairwise (repeat_interleave(2, -1))."""
    import numpy as np

    nb = head_dim // 4
    bands = 1.0 / (temperature ** (np.arange(nb) / nb))
    ts = [np.arange(s, dtype=np.float64) for s in grid]
    if ref_shape:
        ts = [t / g * r for t, g, r in zip(ts, grid, ref_shape)]
    mesh = np.stack(np.meshgrid(*ts, indexing="ij"), axis=-1)  # [H, W, 2]
    pos = mesh[..., None] * bands                              # [H, W, 2, nb]
    n = grid[0] * grid[1]
    sin = np.repeat(np.sin(pos).reshape(n, -1), 2, axis=-1)
    cos = np.repeat(np.cos(pos).reshape(n, -1), 2, axis=-1)
    return sin.astype(np.float32), cos.astype(np.float32)


def _rot_pairs(x: jax.Array) -> jax.Array:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return jnp.stack([-x2[..., 1], x2[..., 0]], axis=-1).reshape(x.shape)


def _apply_rope_cat(x: jax.Array, sin: jax.Array, cos: jax.Array) -> jax.Array:
    return x * cos + _rot_pairs(x) * sin


class Eva02Attention(nn.Module):
    cfg: VisionConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, sin, cos):
        cfg = self.cfg
        b, n, d = x.shape
        heads = cfg.heads
        hd = d // heads
        dt = self.dtype
        if cfg.eva_post_norm:
            # fused qkv, BEiT bias layout [q; 0; v]
            qkv = nn.Dense(3 * d, use_bias=True, dtype=dt, name="in_proj")(x)
            q, k, v = jnp.split(qkv, 3, axis=-1)
        else:
            q = nn.Dense(d, use_bias=True, dtype=dt, name="q_proj")(x)
            k = nn.Dense(d, use_bias=False, dtype=dt, name="k_proj")(x)
            v = nn.Dense(d, use_bias=True, dtype=dt, name="v_proj")(x)

        def split_heads(t):
            return t.reshape(b, n, heads, hd).transpose(0, 2, 1, 3)

        q, k, v = split_heads(q), split_heads(k), split_heads(v)
        if cfg.eva_rope:
            # rope on patch tokens only; cls (index 0) passes through
            q = jnp.concatenate(
                [q[:, :, :1], _apply_rope_cat(q[:, :, 1:], sin, cos)], axis=2
            ).astype(v.dtype)
            k = jnp.concatenate(
                [k[:, :, :1], _apply_rope_cat(k[:, :, 1:], sin, cos)], axis=2
            ).astype(v.dtype)
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                       preferred_element_type=jnp.float32) * (hd ** -0.5)
        p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
        o = jnp.einsum("bhqk,bhkd->bhqd", p, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, n, d)
        if cfg.eva_attn_inner_norm:
            o = nn.LayerNorm(epsilon=1e-6, dtype=dt, name="inner_norm")(o)
        return nn.Dense(d, use_bias=True, dtype=dt, name="out_proj")(o)


class Eva02Mlp(nn.Module):
    cfg: VisionConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x):
        cfg = self.cfg
        d = x.shape[-1]
        hidden = int(d * cfg.mlp_ratio)
        dt = self.dtype
        if cfg.eva_swiglu:
            gate = nn.Dense(hidden, dtype=dt, name="fc1_g")(x)
            h = nn.Dense(hidden, dtype=dt, name="fc1_x")(x)
            h = nn.silu(gate) * h
            h = nn.LayerNorm(epsilon=1e-6, dtype=dt, name="norm")(h)
            return nn.Dense(d, dtype=dt, name="fc2")(h)
        h = nn.Dense(hidden, dtype=dt, name="c_fc")(x)
        h = nn.gelu(h, approximate=False)
        return nn.Dense(d, dtype=dt, name="c_proj")(h)


class Eva02Block(nn.Module):
    cfg: VisionConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, sin, cos):
        cfg = self.cfg
        dt = self.dtype
        attn = Eva02Attention(cfg, dtype=dt, name="attn")
        mlp = Eva02Mlp(cfg, dtype=dt, name="mlp")
        ln1 = nn.LayerNorm(epsilon=1e-6, dtype=dt, name="ln_1")
        ln2 = nn.LayerNorm(epsilon=1e-6, dtype=dt, name="ln_2")
        if cfg.eva_post_norm:
            x = x + ln1(attn(x, sin, cos))
            x = x + ln2(mlp(x))
        else:
            x = x + attn(ln1(x), sin, cos)
            x = x + mlp(ln2(x))
        return x


class EVA02VisionTower(nn.Module):
    """EVA02 trunk (timm eva.py) + CLIP head projection."""

    cfg: VisionConfig
    embed_dim: int
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        b = images.shape[0]
        x = patchify(images.astype(self.dtype), cfg.patch_size)
        x = nn.Dense(cfg.width, use_bias=True, dtype=self.dtype,
                     name="patch_embed")(x)
        cls = self.param(
            "cls_token", nn.initializers.normal(0.02), (cfg.width,)
        )
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1,
        )
        pos = self.param(
            "pos_embed", nn.initializers.normal(0.02),
            (x.shape[1], cfg.width),
        )
        x = x + pos.astype(self.dtype)

        sin = cos = None
        if cfg.eva_rope:
            import numpy as np  # noqa: F401  (static precompute)

            g = cfg.grid_size
            sin_np, cos_np = eva02_rope_embed(
                (g, g), cfg.width // cfg.heads,
                tuple(cfg.eva_ref_feat_shape) or (),
            )
            sin, cos = jnp.asarray(sin_np, self.dtype), jnp.asarray(
                cos_np, self.dtype)

        block = Eva02Block
        if self.remat:
            block = nn.remat(Eva02Block, static_argnums=())
        for i in range(cfg.layers):
            x = block(cfg, dtype=self.dtype, name=f"resblocks_{i}")(
                x, sin, cos)
        x = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm")(x)
        pooled = nn.Dense(self.embed_dim, dtype=self.dtype, name="head")(
            x[:, 0]
        )
        return pooled, x[:, 1:]


def convert_eva02_trunk_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual.trunk."
) -> Dict[str, Any]:
    """open_clip EVA02 checkpoint (timm visual.trunk.*) -> EVA02VisionTower.

    Handles both the split-projection SwiGLU layout (q_proj/k_proj/v_proj,
    attn.norm, mlp.fc1_g/fc1_x/mlp.norm/fc2) and the fused post-norm layout
    (qkv + q_bias/v_bias, mlp.fc1/fc2)."""
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
        attn: Dict[str, Any]
        if f"{pre}.attn.q_proj.weight" in sd:
            attn = {
                "q_proj": _linear(sd, f"{pre}.attn.q_proj"),
                "k_proj": {"kernel": _np(sd[f"{pre}.attn.k_proj.weight"]).T},
                "v_proj": _linear(sd, f"{pre}.attn.v_proj"),
                "out_proj": _linear(sd, f"{pre}.attn.proj"),
            }
        else:
            qkv_w = _np(sd[f"{pre}.attn.qkv.weight"])
            if f"{pre}.attn.qkv.bias" in sd:
                qkv_b = _np(sd[f"{pre}.attn.qkv.bias"])
            else:
                q_b = _np(sd[f"{pre}.attn.q_bias"])
                v_b = _np(sd[f"{pre}.attn.v_bias"])
                qkv_b = np.concatenate([q_b, np.zeros_like(q_b), v_b])
            attn = {
                "in_proj": {"kernel": qkv_w.T, "bias": qkv_b},
                "out_proj": _linear(sd, f"{pre}.attn.proj"),
            }
        if f"{pre}.attn.norm.weight" in sd:
            attn["inner_norm"] = _layernorm(sd, f"{pre}.attn.norm")
        mlp: Dict[str, Any]
        if f"{pre}.mlp.fc1_g.weight" in sd:
            mlp = {
                "fc1_g": _linear(sd, f"{pre}.mlp.fc1_g"),
                "fc1_x": _linear(sd, f"{pre}.mlp.fc1_x"),
                "norm": _layernorm(sd, f"{pre}.mlp.norm"),
                "fc2": _linear(sd, f"{pre}.mlp.fc2"),
            }
        else:
            mlp = {
                "c_fc": _linear(sd, f"{pre}.mlp.fc1"),
                "c_proj": _linear(sd, f"{pre}.mlp.fc2"),
            }
        blocks[f"resblocks_{i}"] = {
            "ln_1": _layernorm(sd, f"{pre}.norm1"),
            "attn": attn,
            "ln_2": _layernorm(sd, f"{pre}.norm2"),
            "mlp": mlp,
        }
    return {
        "patch_embed": {
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width),
            "bias": _np(sd["patch_embed.proj.bias"]),
        },
        "cls_token": _np(sd["cls_token"]).reshape(-1),
        "pos_embed": _np(sd["pos_embed"]).reshape(-1, width),
        **{f"resblocks_{i}": blocks[f"resblocks_{i}"] for i in range(n)},
        "norm": _layernorm(sd, "norm"),
        "head": _linear(sd, "head"),
    }


def convert_eva_trunk_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual.trunk."
) -> Dict[str, Any]:
    """open_clip EVA checkpoint (visual.trunk.*) -> EVAVisionTower params.

    Handles both fused-bias (qkv.bias) and BEiT-style split-bias
    (q_bias/v_bias, zero k) layouts."""
    import numpy as np

    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    conv_w = _np(sd["patch_embed.proj.weight"])  # [W, 3, p, p]
    width, cin, p, _ = conv_w.shape

    n = 0
    while f"blocks.{n}.norm1.weight" in sd:
        n += 1
    blocks: Dict[str, Any] = {}
    for i in range(n):
        pre = f"blocks.{i}"
        qkv_w = _np(sd[f"{pre}.attn.qkv.weight"])
        if f"{pre}.attn.qkv.bias" in sd:
            qkv_b = _np(sd[f"{pre}.attn.qkv.bias"])
        else:
            q_b = _np(sd[f"{pre}.attn.q_bias"])
            v_b = _np(sd[f"{pre}.attn.v_bias"])
            qkv_b = np.concatenate([q_b, np.zeros_like(q_b), v_b])
        blocks[f"resblocks_{i}"] = {
            "ln_1": _layernorm(sd, f"{pre}.norm1"),
            "attn": {
                "in_proj": {"kernel": qkv_w.T, "bias": qkv_b},
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
        "head": _linear(sd, "head"),
    }
