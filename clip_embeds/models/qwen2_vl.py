"""Qwen2-VL: native-resolution ViT (2D RoPE) + patch merger + Qwen2 M-RoPE LM.

Reference: VLM2Vec/src/vlm_backbone/qwen2_vl/modeling_qwen2_vl.py —
PatchEmbed conv3d (:74-97), VisionRotaryEmbedding + grouped h/w position ids
(:100-109, :357-384), VisionAttention with per-frame cu_seqlens (:192-224),
PatchMerger (:133-146), M-RoPE channel sections (:489-531), 3D
get_rope_index (:1392-1540). The HF Qwen2VLImageProcessor's smart_resize +
merge-grouped patch flattening (image_processing_qwen2_vl.py) is reproduced
host-side.

Static-shape redesign:
* the reference packs variable-resolution images into one ragged token stream
  with `flash_attn_varlen_func`; XLA wants static shapes, so a call processes
  a batch of SAME-grid images ([B, L, patch_dim] with a static (t, h, w)) and
  mixed-resolution batches bucket by grid — the standard XLA approach.
* the conv3d patchify is a single Dense over the processor's flattened patch
  features (kernel == stride makes them equivalent).
* vision 2D RoPE tables are built at trace time from the static grid.
* image features scatter into the text stream at the image-pad token
  positions via a cumsum gather (static shapes), and the LM consumes
  [B, 3, N] (t, h, w) position ids (models/llama.py mrope_section).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

from .clip import l2_normalize
from .layers import exact_gelu, quick_gelu
from .llama import LlamaConfig, LlamaForCausalLM

Dtype = Any


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # LM width (merger output)
    mlp_ratio: float = 4.0
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (
            self.in_channels * self.temporal_patch_size * self.patch_size ** 2
        )


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    text: LlamaConfig = dataclasses.field(
        default_factory=lambda: LlamaConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1e6,
            rms_norm_eps=1e-6, attention_bias=True,
            mrope_section=(16, 24, 24),
        )
    )
    vision: Qwen2VLVisionConfig = dataclasses.field(
        default_factory=Qwen2VLVisionConfig
    )
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


# -- host preprocessing ------------------------------------------------------


def smart_resize(
    height: int, width: int, factor: int = 28,
    min_pixels: int = 56 * 56, max_pixels: int = 14 * 14 * 4 * 1280,
) -> Tuple[int, int]:
    """HF Qwen2VLImageProcessor.smart_resize: round to multiples of
    patch*merge keeping the pixel count in [min, max]."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio must be < 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def image_to_patches(
    image_chw: np.ndarray,           # normalized float [C, H, W] (or [T,C,H,W])
    cfg: Qwen2VLVisionConfig,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Flatten to the processor's merge-grouped patch layout:
    [(t*h*w), C*tp*p*p] ordered (t, h_block, w_block, h_in, w_in) with feature
    order (C, tp, ph, pw) (image_processing_qwen2_vl.py:270-297)."""
    p, m, tp = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    if image_chw.ndim == 3:
        frames = image_chw[None]
    else:
        frames = image_chw
    if frames.shape[0] % tp != 0:
        reps = np.repeat(
            frames[-1:][None][0], tp - frames.shape[0] % tp, axis=0
        )
        frames = np.concatenate([frames, reps], axis=0)
    c = frames.shape[1]
    grid_t = frames.shape[0] // tp
    grid_h, grid_w = frames.shape[2] // p, frames.shape[3] // p
    patches = frames.reshape(
        grid_t, tp, c, grid_h // m, m, p, grid_w // m, m, p
    )
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w, c * tp * p * p)
    return flat.astype(np.float32), (grid_t, grid_h, grid_w)


def get_rope_index(
    input_ids: np.ndarray,            # int [B, L]
    grids: Sequence[Tuple[int, int, int]],  # (t, h, w) per image, in order
    attention_mask: Optional[np.ndarray],
    cfg: Qwen2VLConfig,
) -> np.ndarray:
    """3D (t, h, w) position ids [B, 3, L] (get_rope_index,
    modeling_qwen2_vl.py:1392-1540; image-only variant — the text spans get
    1D positions, each vision span gets its grid coordinates offset to start
    after the preceding text)."""
    b, l = input_ids.shape
    m = cfg.vision.spatial_merge_size
    if attention_mask is None:
        attention_mask = np.ones((b, l), np.int64)
    out = np.ones((3, b, l), np.int64)
    image_index = 0
    for i in range(b):
        ids = input_ids[i][attention_mask[i] == 1]
        spans: List[np.ndarray] = []
        st = 0
        tokens = ids.tolist()
        while True:
            try:
                ed = tokens.index(cfg.image_token_id, st)
            except ValueError:
                break
            t, h, w = grids[image_index]
            image_index += 1
            gh, gw = h // m, w // m
            st_idx = spans[-1].max() + 1 if spans else 0
            text_len = ed - st
            spans.append(
                np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx
            )
            t_idx = np.repeat(np.arange(t), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.arange(gw), t * gh)
            spans.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + t * gh * gw
        if st < len(tokens):
            st_idx = spans[-1].max() + 1 if spans else 0
            text_len = len(tokens) - st
            spans.append(
                np.broadcast_to(np.arange(text_len), (3, text_len)) + st_idx
            )
        pos = np.concatenate(spans, axis=1)
        out[:, i, attention_mask[i] == 1] = pos
    return out.transpose(1, 0, 2)  # [B, 3, L]


# -- vision tower ------------------------------------------------------------


def _vision_rope(
    grid: Tuple[int, int, int], head_dim: int, merge: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [L, head_dim] numpy tables for a static grid — the grouped
    h/w position ids of rot_pos_emb (modeling_qwen2_vl.py:357-384)."""
    t, h, w = grid
    hpos = np.arange(h)[:, None] * np.ones((1, w), np.int64)
    wpos = np.ones((h, 1), np.int64) * np.arange(w)[None, :]

    def group(x):
        x = x.reshape(h // merge, merge, w // merge, merge)
        return x.transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = group(hpos), group(wpos)
    dim = head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, np.float32) / dim))
    h_ang = hpos[:, None].astype(np.float32) * inv_freq  # [hw, hd/4]
    w_ang = wpos[:, None].astype(np.float32) * inv_freq
    ang = np.concatenate([h_ang, w_ang], axis=-1)        # [hw, hd/2]
    ang = np.tile(ang, (t, 1))
    full = np.concatenate([ang, ang], axis=-1)           # [L, hd]
    return np.cos(full), np.sin(full)


def _rotate_half(x: jax.Array) -> jax.Array:
    half = x.shape[-1] // 2
    return jnp.concatenate([-x[..., half:], x[..., :half]], axis=-1)


class Qwen2VisionBlock(nn.Module):
    cfg: Qwen2VLVisionConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jax.Array,                 # [B, L, D]
        cos: jax.Array,               # [L, hd]
        sin: jax.Array,
        frame_mask: Optional[jax.Array],  # bool [L, L] or None
    ) -> jax.Array:
        cfg = self.cfg
        b, l, d = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim

        h = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm1")(x)
        qkv = nn.Dense(3 * d, dtype=self.dtype, name="qkv")(h)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def heads(t):
            return t.reshape(b, l, nh, hd).transpose(0, 2, 1, 3)

        q, k, v = heads(q), heads(k), heads(v)
        cos_ = cos[None, None].astype(jnp.float32)
        sin_ = sin[None, None].astype(jnp.float32)
        q = (q.astype(jnp.float32) * cos_ + _rotate_half(
            q.astype(jnp.float32)) * sin_).astype(v.dtype)
        k = (k.astype(jnp.float32) * cos_ + _rotate_half(
            k.astype(jnp.float32)) * sin_).astype(v.dtype)

        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
        ) * (hd ** -0.5)
        if frame_mask is not None:
            logits = jnp.where(frame_mask[None, None], logits, -1e9)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, l, d)
        x = x + nn.Dense(d, dtype=self.dtype, name="proj")(out)

        h = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="norm2")(x)
        h = nn.Dense(int(d * cfg.mlp_ratio), dtype=self.dtype, name="fc1")(h)
        h = quick_gelu(h)  # qwen2-vl vision hidden_act
        return x + nn.Dense(d, dtype=self.dtype, name="fc2")(h)


class Qwen2VisionTower(nn.Module):
    """Native-resolution vision tower over one static (t, h, w) grid."""

    cfg: Qwen2VLVisionConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(
        self,
        patches: jax.Array,            # [B, L, patch_dim] processor layout
        grid: Tuple[int, int, int],    # static
    ) -> jax.Array:
        """-> merged image features [B, L / merge^2, hidden_size]."""
        cfg = self.cfg
        t, h, w = grid
        b, l, _ = patches.shape
        assert l == t * h * w, (l, grid)
        x = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                     name="patch_embed")(patches.astype(self.dtype))

        cos_np, sin_np = _vision_rope(grid, cfg.head_dim, cfg.spatial_merge_size)
        cos, sin = jnp.asarray(cos_np), jnp.asarray(sin_np)

        frame_mask = None
        if t > 1:
            # attention is within each temporal frame (cu_seqlens,
            # modeling_qwen2_vl.py:390-398)
            fid = jnp.repeat(jnp.arange(t), h * w)
            frame_mask = fid[:, None] == fid[None, :]

        block = Qwen2VisionBlock
        if self.remat:
            block = nn.remat(Qwen2VisionBlock, static_argnums=())
        for i in range(cfg.depth):
            x = block(cfg, dtype=self.dtype, name=f"blocks_{i}")(
                x, cos, sin, frame_mask
            )

        # PatchMerger: LN then group merge^2 consecutive tokens
        m2 = cfg.spatial_merge_size ** 2
        x = nn.LayerNorm(epsilon=1e-6, dtype=self.dtype, name="ln_q")(x)
        x = x.reshape(b, l // m2, m2 * cfg.embed_dim)
        x = nn.Dense(m2 * cfg.embed_dim, dtype=self.dtype, name="merger_fc1")(x)
        x = exact_gelu(x)
        return nn.Dense(cfg.hidden_size, dtype=self.dtype, name="merger_fc2")(x)


# -- full model ---------------------------------------------------------------


class Qwen2VL(nn.Module):
    cfg: Qwen2VLConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant_llm: str = ""  # W8A8 trunk projections ('' | 'dynamic' | 'static'):
    # the Qwen2-7B trunk is ~15.2 GB bf16 vs ~7.9 GB int8

    def setup(self):
        self.visual = Qwen2VisionTower(
            self.cfg.vision, dtype=self.dtype, remat=self.remat
        )
        self.language_model = LlamaForCausalLM(
            self.cfg.text, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat, quant=self.quant_llm,
        )

    def merge(
        self,
        input_ids: jax.Array,          # [B, L] with image-pad tokens
        image_features: jax.Array,     # [B, Lv, H] merged vision features
    ) -> jax.Array:
        """Scatter image features at the image-pad positions in order
        (reference masked_scatter; static-shape cumsum gather)."""
        image_mask = input_ids == self.cfg.image_token_id
        text_embeds = self.language_model.embed(
            jnp.where(input_ids < 0, 0, input_ids)
        )
        idx = jnp.cumsum(image_mask.astype(jnp.int32), axis=1) - 1
        idx = jnp.clip(idx, 0, image_features.shape[1] - 1)
        gathered = jnp.take_along_axis(
            image_features, idx[..., None], axis=1
        )
        return jnp.where(image_mask[..., None], gathered, text_embeds)

    def __call__(
        self,
        input_ids: jax.Array,          # [B, L]
        patches: Optional[jax.Array] = None,   # [B, Lv*m^2, patch_dim]
        grid: Optional[Tuple[int, int, int]] = None,
        attention_mask: Optional[jax.Array] = None,   # bool [B, L]
        positions: Optional[jax.Array] = None,        # int [B, 3, L]
    ) -> jax.Array:
        """Logits [B, L, vocab]."""
        if patches is not None:
            feats = self.visual(patches, grid)
            embeds = self.merge(input_ids, feats)
        else:
            embeds = self.language_model.embed(
                jnp.where(input_ids < 0, 0, input_ids)
            )
        mask = attention_mask.astype(bool) if attention_mask is not None else None
        hidden = self.language_model.trunk(embeds, mask, positions)
        return self.language_model.logits(hidden)

    def embed_last_token(
        self,
        input_ids: jax.Array,
        patches: Optional[jax.Array] = None,
        grid: Optional[Tuple[int, int, int]] = None,
        attention_mask: Optional[jax.Array] = None,
        positions: Optional[jax.Array] = None,
    ) -> jax.Array:
        """VLM2Vec pooling: last valid token hidden state, L2-normalized."""
        if patches is not None:
            feats = self.visual(patches, grid)
            embeds = self.merge(input_ids, feats)
        else:
            embeds = self.language_model.embed(
                jnp.where(input_ids < 0, 0, input_ids)
            )
        if attention_mask is None:
            attention_mask = jnp.ones(input_ids.shape, jnp.int32)
        mask = attention_mask.astype(bool)
        hidden = self.language_model.trunk(embeds, mask, positions)
        last = jnp.sum(attention_mask.astype(jnp.int32), axis=1) - 1
        pooled = jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0]
        return l2_normalize(pooled)


# -- Qwen2.5-VL ---------------------------------------------------------------
#
# Reference: VLM2Vec/src/vlm_backbone/qwen2_5_vl/ (vendored HF fork). The
# vision tower differs from Qwen2-VL in three ways (HF
# modeling_qwen2_5_vl.py Qwen2_5_VisionTransformerPretrainedModel):
#   * RMSNorm (eps 1e-6) instead of LayerNorm, SiLU gate/up/down MLP (bias)
#   * WINDOW attention: merge-groups are reordered window-major
#     (get_window_index) and all but `fullatt_block_indexes` layers attend
#     only within their (window_size/merge/patch)^2-cell window
#   * the patch merger RMS-normalizes before the 2-layer MLP
# Static shapes: the window permutation + segment ids are a pure function of the
# static grid, so they are computed host-side in numpy at trace time and the
# reorder is a static gather; window masking is a segment-id equality mask
# (identical math to the reference's cu_seqlens varlen attention).


@dataclasses.dataclass(frozen=True)
class Qwen25VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280            # HF hidden_size
    intermediate_size: int = 3420
    hidden_size: int = 3584          # HF out_hidden_size (merger output)
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return (
            self.in_channels * self.temporal_patch_size * self.patch_size ** 2
        )


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    text: LlamaConfig = dataclasses.field(
        default_factory=lambda: LlamaConfig(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, rope_theta=1e6,
            rms_norm_eps=1e-6, attention_bias=True,
            mrope_section=(16, 24, 24),
        )
    )
    vision: Qwen25VLVisionConfig = dataclasses.field(
        default_factory=Qwen25VLVisionConfig
    )
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652


def _window_plan(
    grid: Tuple[int, int, int], cfg: Qwen25VLVisionConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, win_id) over merge-groups for a static grid.

    perm[new_pos] = original merge-group index (the get_window_index
    reorder); win_id[new_pos] = window segment id of that group (windows are
    per (t, win_h, win_w); ragged edges keep their smaller windows)."""
    t, h, w = grid
    m = cfg.spatial_merge_size
    lh, lw = h // m, w // m
    vw = cfg.window_size // m // cfg.patch_size  # cells per window side
    pad_h = (-lh) % vw
    pad_w = (-lw) % vw
    nwh, nww = (lh + pad_h) // vw, (lw + pad_w) // vw
    index = np.arange(t * lh * lw).reshape(t, lh, lw)
    padded = np.full((t, lh + pad_h, lw + pad_w), -100, np.int64)
    padded[:, :lh, :lw] = index
    padded = padded.reshape(t, nwh, vw, nww, vw)
    padded = padded.transpose(0, 1, 3, 2, 4).reshape(t, nwh * nww, vw, vw)
    flat = padded.reshape(-1)
    perm = flat[flat != -100]
    win = np.broadcast_to(
        np.arange(t * nwh * nww).reshape(t, nwh * nww, 1, 1), padded.shape
    ).reshape(-1)
    win_id = win[flat != -100]
    return perm, win_id


class Qwen25VisionBlock(nn.Module):
    cfg: Qwen25VLVisionConfig
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self,
        x: jax.Array,                  # [B, L, D]
        cos: jax.Array,                # [L, hd]
        sin: jax.Array,
        attn_mask: Optional[jax.Array],  # bool [L, L] or None
    ) -> jax.Array:
        from .llama import RMSNorm

        cfg = self.cfg
        b, l, d = x.shape
        nh, hd = cfg.num_heads, cfg.head_dim

        h = RMSNorm(1e-6, self.dtype, name="norm1")(x)
        qkv = nn.Dense(3 * d, dtype=self.dtype, name="qkv")(h)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def heads(t):
            return t.reshape(b, l, nh, hd).transpose(0, 2, 1, 3)

        q, k, v = heads(q), heads(k), heads(v)
        cos_ = cos[None, None].astype(jnp.float32)
        sin_ = sin[None, None].astype(jnp.float32)
        q = (q.astype(jnp.float32) * cos_ + _rotate_half(
            q.astype(jnp.float32)) * sin_).astype(v.dtype)
        k = (k.astype(jnp.float32) * cos_ + _rotate_half(
            k.astype(jnp.float32)) * sin_).astype(v.dtype)

        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
        ) * (hd ** -0.5)
        if attn_mask is not None:
            logits = jnp.where(attn_mask[None, None], logits, -1e9)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, l, d)
        x = x + nn.Dense(d, dtype=self.dtype, name="proj")(out)

        h = RMSNorm(1e-6, self.dtype, name="norm2")(x)
        gate = nn.Dense(cfg.intermediate_size, dtype=self.dtype,
                        name="gate_proj")(h)
        up = nn.Dense(cfg.intermediate_size, dtype=self.dtype,
                      name="up_proj")(h)
        h = jax.nn.silu(gate) * up
        return x + nn.Dense(d, dtype=self.dtype, name="down_proj")(h)


class Qwen25VisionTower(nn.Module):
    """Qwen2.5-VL window-attention vision tower over one static grid."""

    cfg: Qwen25VLVisionConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(
        self,
        patches: jax.Array,            # [B, L, patch_dim] processor layout
        grid: Tuple[int, int, int],    # static
    ) -> jax.Array:
        """-> merged image features [B, L / merge^2, hidden_size]."""
        from .llama import RMSNorm

        cfg = self.cfg
        t, h, w = grid
        b, l, _ = patches.shape
        assert l == t * h * w, (l, grid)
        m2 = cfg.spatial_merge_size ** 2

        x = nn.Dense(cfg.embed_dim, use_bias=False, dtype=self.dtype,
                     name="patch_embed")(patches.astype(self.dtype))

        perm, win_id = _window_plan(grid, cfg)

        # reorder merge-groups window-major (static gather)
        x = x.reshape(b, l // m2, m2, cfg.embed_dim)[:, perm]
        x = x.reshape(b, l, cfg.embed_dim)

        # rope tables in the same (grouped, then window-permuted) order
        cos_np, sin_np = _vision_rope(
            grid, cfg.head_dim, cfg.spatial_merge_size
        )
        cos_np = cos_np.reshape(l // m2, m2, -1)[perm].reshape(l, -1)
        sin_np = sin_np.reshape(l // m2, m2, -1)[perm].reshape(l, -1)
        cos, sin = jnp.asarray(cos_np), jnp.asarray(sin_np)

        # token-level segment ids (window / frame) in the reordered layout
        win_tok = np.repeat(win_id, m2)
        window_mask = jnp.asarray(win_tok[:, None] == win_tok[None, :])
        full_mask = None
        if t > 1:
            # frame id of each merge-group = group_index // (lh * lw)
            lh, lw = h // cfg.spatial_merge_size, w // cfg.spatial_merge_size
            frame_tok = np.repeat(perm // (lh * lw), m2)
            full_mask = jnp.asarray(
                frame_tok[:, None] == frame_tok[None, :]
            )

        block = Qwen25VisionBlock
        if self.remat:
            block = nn.remat(Qwen25VisionBlock, static_argnums=())
        for i in range(cfg.depth):
            mask = (
                full_mask if i in cfg.fullatt_block_indexes else window_mask
            )
            x = block(cfg, dtype=self.dtype, name=f"blocks_{i}")(
                x, cos, sin, mask
            )

        # merger: RMS ln_q, group merge^2 consecutive tokens, 2-layer MLP
        x = RMSNorm(1e-6, self.dtype, name="ln_q")(x)
        x = x.reshape(b, l // m2, m2 * cfg.embed_dim)
        x = nn.Dense(m2 * cfg.embed_dim, dtype=self.dtype,
                     name="merger_fc1")(x)
        x = exact_gelu(x)
        x = nn.Dense(cfg.hidden_size, dtype=self.dtype, name="merger_fc2")(x)

        # restore original merge-group order for the LM splice
        inv = np.argsort(perm)
        return x[:, inv]


class Qwen25VL(nn.Module):
    """Qwen2.5-VL: window-attention tower + the Qwen2 M-RoPE trunk."""

    cfg: Qwen25VLConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        self.visual = Qwen25VisionTower(
            self.cfg.vision, dtype=self.dtype, remat=self.remat
        )
        self.language_model = LlamaForCausalLM(
            self.cfg.text, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat,
        )

    merge = Qwen2VL.merge
    __call__ = Qwen2VL.__call__
    embed_last_token = Qwen2VL.embed_last_token
