"""LLaVA-Next / LLaVA-1.6 (AnyRes) — static-shape redesign.

Reference: VLM2Vec/src/vlm_backbone/llava_next/modeling_llava_next.py
(get_anyres_image_grid_shape :47-74, unpad_image :114-150,
pack_image_features :657-717, ragged merge :416-655) and the t2v_metrics
vendored llava_16/model/llava_arch.py (select_best_resolution :38-65,
resize_and_pad :68-100, divide_to_patches :103-122, spatial_unpad merge
:280-314).

The torch reference packs a *ragged* feature sequence per image (base crop
features + unpadded spatial grid + a learned newline column) and scatters it
into the token stream at runtime. XLA needs static shapes, so the rebuild
splits the work:

* **host plan** (numpy, per image): choose the best grid-pinpoint resolution,
  compute the unpad row/col ranges, and emit three fixed-width arrays over a
  static ``max_features`` budget — ``gather`` (index into the flattened
  [num_crops+1, n_base] crop-feature pool), ``is_newline``, ``valid``.
* **device pack** (jit): one `take_along_axis` gather + a `where` against the
  learned ``image_newline`` embedding. No data-dependent shapes.
* **merge**: the single image sentinel expands to the static max_features
  block (models/llava.py splice); invalid feature slots are masked out of
  attention and RoPE positions are re-derived as ``cumsum(mask) - 1`` so
  valid tokens see exactly the packed layout's positions (reference
  modeling_llava_next.py:654 does the same masked-cumsum).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .llama import LlamaConfig, LlamaForCausalLM
from .llava import MultiModalProjector, expand_like_tokens, splice_positions
from .vit import VisionTransformer

Dtype = Any

# HF llava-v1.6 default grid pinpoints, (height, width)
DEFAULT_GRID_PINPOINTS: Tuple[Tuple[int, int], ...] = (
    (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008),
)


def select_best_resolution(
    original_hw: Tuple[int, int],
    possible_resolutions: Sequence[Tuple[int, int]],
) -> Tuple[int, int]:
    """Best-fit (height, width) pinpoint: maximize effective resolution then
    minimize waste (transformers select_best_resolution; llava_arch.py:38-65
    is the same rule in (w, h) order)."""
    oh, ow = original_hw
    best = None
    max_effective = 0
    min_wasted = float("inf")
    for h, w in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = w * h - effective
        if effective > max_effective or (
            effective == max_effective and wasted < min_wasted
        ):
            max_effective, min_wasted = effective, wasted
            best = (h, w)
    assert best is not None
    return best


def anyres_grid_shape(
    original_hw: Tuple[int, int],
    grid_pinpoints: Sequence[Tuple[int, int]],
    crop_size: int,
) -> Tuple[int, int]:
    """(num_patch_h, num_patch_w) for the chosen pinpoint
    (modeling_llava_next.py:47-74)."""
    h, w = select_best_resolution(original_hw, grid_pinpoints)
    return h // crop_size, w // crop_size


def max_num_crops(grid_pinpoints: Sequence[Tuple[int, int]], crop_size: int) -> int:
    return max((h // crop_size) * (w // crop_size) for h, w in grid_pinpoints)


@dataclasses.dataclass
class AnyresPackPlan:
    """Host-computed static-shape packing plan for one image."""

    gather: np.ndarray      # int32 [max_features] into [(1+max_crops)*n_base]
    is_newline: np.ndarray  # bool [max_features]
    valid: np.ndarray       # bool [max_features]
    num_crops: int          # spatial crops actually used (excl. base)
    feature_len: int


def anyres_pack_plan(
    original_hw: Tuple[int, int],
    grid_pinpoints: Sequence[Tuple[int, int]],
    vision_size: int,
    patch_size: int,
    max_features: Optional[int] = None,
) -> AnyresPackPlan:
    """Replicates pack_image_features (modeling_llava_next.py:657-717) as
    index arithmetic: base features first, then the unpadded spatial grid in
    row-major order with a newline token closing each row."""
    g = vision_size // patch_size
    n_base = g * g
    if max_features is None:
        max_features = anyres_max_features(grid_pinpoints, vision_size, patch_size)
    nph, npw = anyres_grid_shape(original_hw, grid_pinpoints, vision_size)
    rows, cols = nph * g, npw * g

    # unpad_image (modeling_llava_next.py:114-150), original (h, w) order
    oh, ow = original_hw
    if ow / oh > cols / rows:
        scale = cols / ow
        new_h = int(oh * scale)
        pad = (rows - new_h) // 2
        r0, r1, c0, c1 = pad, rows - pad, 0, cols
    else:
        scale = rows / oh
        new_w = int(ow * scale)
        pad = (cols - new_w) // 2
        r0, r1, c0, c1 = 0, rows, pad, cols - pad

    gather = np.zeros((max_features,), np.int32)
    is_newline = np.zeros((max_features,), bool)
    valid = np.zeros((max_features,), bool)

    # base crop (index 0) contributes its n_base patch features verbatim
    gather[:n_base] = np.arange(n_base, dtype=np.int32)
    valid[:n_base] = True
    k = n_base
    for r in range(r0, r1):
        for c in range(c0, c1):
            crop = 1 + (r // g) * npw + (c // g)
            pos = (r % g) * g + (c % g)
            gather[k] = crop * n_base + pos
            valid[k] = True
            k += 1
        is_newline[k] = True
        valid[k] = True
        k += 1
    assert k <= max_features, (k, max_features)
    return AnyresPackPlan(
        gather=gather, is_newline=is_newline, valid=valid,
        num_crops=nph * npw, feature_len=k,
    )


def anyres_max_features(
    grid_pinpoints: Sequence[Tuple[int, int]],
    vision_size: int,
    patch_size: int,
) -> int:
    """Static feature budget: base + the largest possible unpadded grid
    (no unpad: full rows x (cols+1))."""
    g = vision_size // patch_size
    best = 0
    for h, w in grid_pinpoints:
        rows = (h // vision_size) * g
        cols = (w // vision_size) * g
        best = max(best, rows * (cols + 1))
    return g * g + best


# -- host preprocessing -----------------------------------------------------


def resize_and_pad(
    image, target_hw: Tuple[int, int]
):
    """PIL resize preserving aspect + center pad to (h, w)
    (llava_arch.py:68-100 / HF _resize_for_patching+_pad_for_patching)."""
    from PIL import Image

    ow, oh = image.size
    th, tw = target_hw
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh), Image.BICUBIC)
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def process_anyres_image(
    image,
    vision_size: int,
    grid_pinpoints: Sequence[Tuple[int, int]],
    mean: Sequence[float],
    std: Sequence[float],
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """One image -> ([1 + max_crops, S, S, 3] float crops (zero-padded),
    original (h, w)). Crop 0 is the squash-resized base image; crops 1..n are
    the best-resolution tiling (HF LlavaNextImageProcessor.get_image_patches)."""
    from ..image.preprocess import _to_pil

    img = _to_pil(image)
    ow, oh = img.size
    best = select_best_resolution((oh, ow), grid_pinpoints)
    padded = resize_and_pad(img, best)

    from PIL import Image

    crops: List[np.ndarray] = [
        np.asarray(img.resize((vision_size, vision_size), Image.BICUBIC))
    ]
    bw, bh = padded.size
    for top in range(0, bh, vision_size):
        for left in range(0, bw, vision_size):
            crops.append(np.asarray(padded.crop(
                (left, top, left + vision_size, top + vision_size)
            )))
    mean_arr = np.asarray(mean, np.float32)
    std_arr = np.asarray(std, np.float32)
    arr = (np.stack(crops).astype(np.float32) / 255.0 - mean_arr) / std_arr
    total = 1 + max_num_crops(grid_pinpoints, vision_size)
    if arr.shape[0] < total:
        pad = np.zeros((total - arr.shape[0],) + arr.shape[1:], np.float32)
        arr = np.concatenate([arr, pad], axis=0)
    return arr, (oh, ow)


# -- device model -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LlavaNextConfig:
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    grid_pinpoints: Tuple[Tuple[int, int], ...] = DEFAULT_GRID_PINPOINTS
    feature_layer: int = -2
    feature_select: str = "patch"  # 'default' strategy == drop CLS
    vision_quick_gelu: bool = True

    @property
    def max_features(self) -> int:
        return anyres_max_features(
            self.grid_pinpoints, self.vision.image_size, self.vision.patch_size
        )

    @property
    def n_base(self) -> int:
        g = self.vision.image_size // self.vision.patch_size
        return g * g


class LlavaNext(nn.Module):
    cfg: LlavaNextConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        self.vision_tower = VisionTransformer(
            self.cfg.vision,
            embed_dim=self.cfg.llama.hidden_size,  # unused (hidden tap)
            quick_gelu=self.cfg.vision_quick_gelu,
            dtype=self.dtype, attn_impl=self.attn_impl, remat=self.remat,
        )
        self.multi_modal_projector = MultiModalProjector(
            self.cfg.llama.hidden_size, dtype=self.dtype
        )
        self.image_newline = self.param(
            "image_newline",
            nn.initializers.normal(self.cfg.llama.hidden_size ** -0.5),
            (self.cfg.llama.hidden_size,),
        )
        self.language_model = LlamaForCausalLM(
            self.cfg.llama, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat,
        )

    def encode_crops(self, pixel_values: jax.Array) -> jax.Array:
        """[B, C, S, S, 3] -> projected crop features [B, C, n_base, hidden]."""
        b, c = pixel_values.shape[:2]
        flat = pixel_values.reshape((b * c,) + pixel_values.shape[2:])
        hidden = self.vision_tower(flat, hidden_layer=self.cfg.feature_layer)
        feats = hidden[:, 1:]  # 'default' strategy: drop CLS
        feats = self.multi_modal_projector(feats)
        return feats.reshape(b, c, feats.shape[1], feats.shape[2])

    def pack(
        self,
        crop_features: jax.Array,  # [B, C, N, D]
        gather: jax.Array,         # int32 [B, F]
        is_newline: jax.Array,     # bool [B, F]
    ) -> jax.Array:
        """Static-shape pack_image_features: [B, F, D]."""
        b, c, n, d = crop_features.shape
        flat = crop_features.reshape(b, c * n, d)
        out = jnp.take_along_axis(flat, gather[..., None], axis=1)
        newline = self.image_newline.astype(out.dtype)
        return jnp.where(is_newline[..., None], newline[None, None], out)

    def merge(
        self,
        input_ids: jax.Array,      # [B, L] with one IMAGE_TOKEN_INDEX each
        packed: jax.Array,         # [B, F, D]
        feat_valid: jax.Array,     # bool [B, F]
        attention_mask: Optional[jax.Array] = None,  # bool [B, L]
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """(embeds [B, L-1+F, D], mask [B, L-1+F], positions) — the ragged
        merge of modeling_llava_next.py:416-655 with masked holes instead of
        ragged lengths; positions = cumsum(mask)-1 matches its line 654."""
        f = packed.shape[1]
        safe_ids = jnp.where(input_ids < 0, 0, input_ids)
        text_embeds = self.language_model.embed(safe_ids)
        _, is_image, text_gather, image_gather = splice_positions(input_ids, f)
        text_part = jnp.take_along_axis(text_embeds, text_gather[..., None], axis=1)
        image_part = jnp.take_along_axis(packed, image_gather[..., None], axis=1)
        embeds = jnp.where(is_image[..., None], image_part, text_part)

        if attention_mask is None:
            attention_mask = jnp.ones(input_ids.shape, bool)
        text_mask = jnp.take_along_axis(
            attention_mask.astype(jnp.int32), text_gather, axis=1
        )
        image_mask = jnp.take_along_axis(
            feat_valid.astype(jnp.int32), image_gather, axis=1
        )
        mask = jnp.where(is_image, image_mask, text_mask)
        positions = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0)
        return embeds, mask.astype(bool), positions

    def __call__(
        self,
        input_ids: jax.Array,       # [B, L]
        pixel_values: jax.Array,    # [B, C, S, S, 3]
        gather: jax.Array,          # int32 [B, F] (host pack plan)
        is_newline: jax.Array,      # bool [B, F]
        feat_valid: jax.Array,      # bool [B, F]
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Logits [B, L - 1 + F, vocab]; invalid slots produce garbage rows
        that callers must ignore via the merge mask (labels there are IGNORE)."""
        feats = self.encode_crops(pixel_values)
        packed = self.pack(feats, gather, is_newline)
        embeds, mask, positions = self.merge(
            input_ids, packed, feat_valid, attention_mask
        )
        hidden = self.language_model.trunk(embeds, mask, positions)
        return self.language_model.logits(hidden)

    def embed_last_token(
        self,
        input_ids: jax.Array,
        pixel_values: Optional[jax.Array] = None,
        gather: Optional[jax.Array] = None,
        is_newline: Optional[jax.Array] = None,
        feat_valid: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """VLM2Vec pooling (MMEBModel._pooling): last *valid* token's hidden
        state, L2-normalized."""
        if pixel_values is not None:
            feats = self.encode_crops(pixel_values)
            packed = self.pack(feats, gather, is_newline)
            embeds, mask, positions = self.merge(
                input_ids, packed, feat_valid, attention_mask
            )
        else:
            embeds = self.language_model.embed(
                jnp.where(input_ids < 0, 0, input_ids)
            )
            mask = (
                attention_mask.astype(bool)
                if attention_mask is not None
                else jnp.ones_like(input_ids, bool)
            )
            positions = jnp.maximum(
                jnp.cumsum(mask.astype(jnp.int32), axis=1) - 1, 0
            )
        hidden = self.language_model.trunk(embeds, mask, positions)
        # last valid position (right-padded holes allowed mid-sequence, so
        # find the max index where mask is set)
        idx = jnp.arange(hidden.shape[1])[None, :]
        last = jnp.max(jnp.where(mask, idx, -1), axis=1)
        pooled = jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0]
        return l2_normalize(pooled)
