"""Phi-3-V: HD-crop image embedding + Phi-3 decoder.

Reference: VLM2Vec/src/vlm_backbone/phi3_v/image_embedding_phi3_v.py —
CLIP-L-336 hidden[-2] patch features (:174-185), 2x2 spatial-to-channel merge
(:283-327), per-row ``sub_GN`` newline + ``glb_GN`` separator with
'sub_glb' ordering (:229-281), 2-layer GELU projection (:146-153), and
scatter at the negative input-id positions (:187-227). Host preprocessing
follows image_processing_phi3_v.py: HD_transform aspect-preserving resize to
a multiple-of-336 canvas (:70-91), white padding (:46-56), a bicubic global
thumbnail, and crop splitting (:270-279).

Static-shape redesign: (h_crop, w_crop) is static per call (mixed shapes bucket by
crop grid), so the whole HD feature transform is static reshapes/transposes
— no ragged packing. Images scatter into the token stream at the negative
sentinel positions via a cumsum gather.
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
from .layers import exact_gelu
from .llama import LlamaConfig, LlamaForCausalLM
from .phi3 import phi3_mini_config
from .vit import VisionTransformer

Dtype = Any

MAX_INPUT_ID = int(1e9)
CROP = 336


# -- host preprocessing -------------------------------------------------------


def hd_transform_grid(width: int, height: int, hd_num: int = 16) -> Tuple[int, int]:
    """(h_crop, w_crop) the HD transform produces for an image
    (calc_hd_transform_size, image_processing_phi3_v.py:94-114)."""
    transposed = False
    if width < height:
        width, height = height, width
        transposed = True
    ratio = width / height
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = scale * CROP
    new_h = int(new_w / ratio)
    padded_h = int(math.ceil(new_h / CROP) * CROP)
    w_crop, h_crop = scale, padded_h // CROP
    if transposed:
        w_crop, h_crop = h_crop, w_crop
    return h_crop, w_crop


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Cubic convolution kernel (torch bicubic, a=-0.75)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


def bicubic_no_antialias(arr: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch.nn.functional.interpolate(mode='bicubic', align_corners=False,
    antialias=False) on an [H, W, C] float array — the reference computes the
    global thumbnail this way on the *normalized* tensor
    (image_processing_phi3_v.py:245-248), which PIL cannot reproduce (PIL
    always antialiases on downscale)."""
    h, w, _ = arr.shape

    def axis_weights(in_size, out_size):
        scale = in_size / out_size
        centers = (np.arange(out_size) + 0.5) * scale - 0.5
        base = np.floor(centers).astype(np.int64) - 1
        offs = np.arange(4)
        idx = base[:, None] + offs[None, :]
        dist = centers[:, None] - idx
        wts = _cubic_kernel(dist)
        wts /= wts.sum(axis=1, keepdims=True)
        idx = np.clip(idx, 0, in_size - 1)
        return idx, wts.astype(np.float32)

    yi, yw = axis_weights(h, out_h)
    xi, xw = axis_weights(w, out_w)
    # rows: [out_h, 4, W, C] -> weighted sum over taps
    rows = (arr[yi] * yw[:, :, None, None]).sum(axis=1)       # [out_h, W, C]
    cols = (rows[:, xi] * xw[None, :, :, None]).sum(axis=2)   # [out_h, out_w, C]
    return cols


def phi3v_process_image(
    image,
    hd_num: int = 16,
    max_crops: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """One image -> ([1 + max_crops, 336, 336, 3] normalized crops (crop 0 =
    global bicubic thumbnail; zero-padded), (h_crop, w_crop)).

    Replicates Phi3VImageProcessor.preprocess: HD resize (transpose-if-tall,
    scale search), white pad to a 336 multiple, 336 thumbnail, crop split in
    (row, col) order, CLIP-stats normalization.
    """
    from PIL import Image

    from ..core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
    from ..image.preprocess import _to_pil

    img = _to_pil(image)
    w, h = img.size
    trans = False
    if w < h:
        img = img.transpose(Image.TRANSPOSE)
        trans = True
        w, h = img.size
    ratio = w / h
    scale = 1
    while scale * math.ceil(scale / ratio) <= hd_num:
        scale += 1
    scale -= 1
    new_w = scale * CROP
    new_h = int(new_w / ratio)
    img = img.resize((new_w, new_h), Image.BILINEAR)
    # padding_336: center-pad the height with white
    tar = int(math.ceil(new_h / CROP) * CROP)
    top = (tar - new_h) // 2
    canvas = Image.new("RGB", (new_w, tar), (255, 255, 255))
    canvas.paste(img, (0, top))
    if trans:
        canvas = canvas.transpose(Image.TRANSPOSE)

    cw, ch = canvas.size
    h_crop, w_crop = ch // CROP, cw // CROP
    mean = np.asarray(OPENAI_DATASET_MEAN, np.float32)
    std = np.asarray(OPENAI_DATASET_STD, np.float32)
    arr = (np.asarray(canvas, np.float32) / 255.0 - mean) / std

    # global thumbnail: torch-style bicubic on the normalized tensor
    crops: List[np.ndarray] = [bicubic_no_antialias(arr, CROP, CROP)]
    for r in range(h_crop):
        for c in range(w_crop):
            crops.append(
                arr[r * CROP : (r + 1) * CROP, c * CROP : (c + 1) * CROP]
            )
    out = np.stack(crops)
    if max_crops is not None and out.shape[0] < 1 + max_crops:
        pad = np.zeros(
            (1 + max_crops - out.shape[0],) + out.shape[1:], np.float32
        )
        out = np.concatenate([out, pad], axis=0)
    return out, (h_crop, w_crop)


def phi3v_num_image_tokens(h_crop: int, w_crop: int) -> int:
    """(num_crops+1)*144 + 1 + (h_crop*12)  newline/separator accounting:
    sub tokens h12*(w12+1) + glb_GN + global 12*13
    (image_processing_phi3_v.py:258)."""
    h12, w12 = h_crop * 12, w_crop * 12
    return h12 * (w12 + 1) + 1 + 12 * 13


# -- device model -------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phi3VConfig:
    text: LlamaConfig = dataclasses.field(default_factory=phi3_mini_config)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    feature_layer: int = -2
    vision_quick_gelu: bool = True


class Phi3VImageEmbedding(nn.Module):
    """HD feature transform: crops -> one packed feature sequence."""

    cfg: Phi3VConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        self.img_processor = VisionTransformer(
            self.cfg.vision,
            embed_dim=self.cfg.text.hidden_size,  # unused (hidden tap)
            quick_gelu=self.cfg.vision_quick_gelu,
            dtype=self.dtype, attn_impl=self.attn_impl, remat=self.remat,
        )
        c4 = self.cfg.vision.width * 4
        self.glb_GN = self.param("glb_GN", nn.initializers.zeros, (c4,))
        self.sub_GN = self.param("sub_GN", nn.initializers.zeros, (c4,))
        self.proj_1 = nn.Dense(
            self.cfg.text.hidden_size, dtype=self.dtype, name="proj_1"
        )
        self.proj_2 = nn.Dense(
            self.cfg.text.hidden_size, dtype=self.dtype, name="proj_2"
        )

    def _merge_2x2(self, feats: jax.Array, h_crop: int, w_crop: int) -> jax.Array:
        """[B*crops, 576, C] -> [B, h_crop*12, w_crop*12, 4C]
        (reshape_hd_patches_2x2merge, image_embedding_phi3_v.py:283-327)."""
        n, l, c = feats.shape
        g = int(round(math.sqrt(l)))
        b = n // (h_crop * w_crop)
        x = feats.reshape(n, g // 2, 2, g // 2, 2, c)
        x = x.transpose(0, 1, 3, 2, 4, 5).reshape(n, (g // 2) ** 2, 4 * c)
        x = x.reshape(b, h_crop, w_crop, g // 2, g // 2, 4 * c)
        x = x.transpose(0, 1, 3, 2, 4, 5)
        return x.reshape(b, h_crop * g // 2, w_crop * g // 2, 4 * c)

    def _add_newline(self, x: jax.Array) -> jax.Array:
        """[B, H, W, C4] -> [B, H*(W+1), C4] with sub_GN closing each row."""
        b, h, w, c4 = x.shape
        newline = jnp.broadcast_to(
            self.sub_GN.astype(x.dtype)[None, None, None], (b, h, 1, c4)
        )
        return jnp.concatenate([x, newline], axis=2).reshape(b, h * (w + 1), c4)

    def __call__(
        self,
        pixel_values: jax.Array,     # [B, 1+max_crops, 336, 336, 3]
        h_crop: int,
        w_crop: int,
    ) -> jax.Array:
        """-> projected image tokens [B, S, hidden] with
        S = h12*(w12+1) + 1 + 156 ('sub_glb' order)."""
        cfg = self.cfg
        b, c_max = pixel_values.shape[:2]
        n_crops = h_crop * w_crop
        used = pixel_values[:, : 1 + n_crops]
        flat = used.reshape((b * (1 + n_crops),) + used.shape[2:])
        hidden = self.img_processor(flat, hidden_layer=cfg.feature_layer)
        feats = hidden[:, 1:]  # patch features
        feats = feats.reshape(b, 1 + n_crops, feats.shape[1], feats.shape[2])

        glb = self._add_newline(self._merge_2x2(feats[:, 0], 1, 1))
        sub = self._add_newline(
            self._merge_2x2(
                feats[:, 1:].reshape((-1,) + feats.shape[2:]), h_crop, w_crop
            )
        )
        sep = jnp.broadcast_to(
            self.glb_GN.astype(feats.dtype)[None, None], (b, 1, self.glb_GN.shape[0])
        )
        seq = jnp.concatenate([sub, sep, glb], axis=1)  # sub_glb order
        return self.proj_2(exact_gelu(self.proj_1(seq)))


class Phi3V(nn.Module):
    cfg: Phi3VConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        self.vision_embed = Phi3VImageEmbedding(
            self.cfg, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat,
        )
        self.language_model = LlamaForCausalLM(
            self.cfg.text, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat,
        )

    def merge(
        self, input_ids: jax.Array, image_features: jax.Array
    ) -> jax.Array:
        """Scatter image tokens at the negative-id positions
        (image_embedding_phi3_v.py:200-222 index_put)."""
        image_mask = (input_ids < 0) & (input_ids > -MAX_INPUT_ID)
        safe = jnp.clip(input_ids, 0, self.cfg.text.vocab_size)
        text_embeds = self.language_model.embed(safe)
        idx = jnp.cumsum(image_mask.astype(jnp.int32), axis=1) - 1
        idx = jnp.clip(idx, 0, image_features.shape[1] - 1)
        gathered = jnp.take_along_axis(image_features, idx[..., None], axis=1)
        return jnp.where(image_mask[..., None], gathered, text_embeds)

    def __call__(
        self,
        input_ids: jax.Array,          # [B, L]; image slots are negative ids
        pixel_values: Optional[jax.Array] = None,
        h_crop: int = 1,
        w_crop: int = 1,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        if pixel_values is not None:
            feats = self.vision_embed(pixel_values, h_crop, w_crop)
            embeds = self.merge(input_ids, feats)
        else:
            embeds = self.language_model.embed(jnp.clip(input_ids, 0, None))
        mask = attention_mask.astype(bool) if attention_mask is not None else None
        hidden = self.language_model.trunk(embeds, mask)
        return self.language_model.logits(hidden)

    def embed_last_token(
        self,
        input_ids: jax.Array,
        pixel_values: Optional[jax.Array] = None,
        h_crop: int = 1,
        w_crop: int = 1,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """VLM2Vec pooling (MMEBModel._pooling)."""
        if pixel_values is not None:
            feats = self.vision_embed(pixel_values, h_crop, w_crop)
            embeds = self.merge(input_ids, feats)
        else:
            embeds = self.language_model.embed(jnp.clip(input_ids, 0, None))
        if attention_mask is None:
            attention_mask = jnp.ones(input_ids.shape, jnp.int32)
        hidden = self.language_model.trunk(
            embeds, attention_mask.astype(bool)
        )
        last = jnp.sum(attention_mask.astype(jnp.int32), axis=1) - 1
        pooled = jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0]
        return l2_normalize(pooled)


def convert_phi3v_image_embedding_state_dict(sd, prefix: str = "") -> dict:
    """Reference Phi3ImageEmbedding state_dict -> Phi3VImageEmbedding params.

    Keys: img_processor.vision_model.* (HF CLIPVisionModel), glb_GN, sub_GN,
    img_projection.{0,2}.{weight,bias} (the projection_cls='mlp' layout)."""
    from ..core.torch_convert import (
        _linear,
        _np,
        convert_hf_clip_vision_state_dict,
    )

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return {
        "img_processor": convert_hf_clip_vision_state_dict(
            sd, prefix="img_processor.vision_model."
        ),
        "glb_GN": _np(sd["glb_GN"]).reshape(-1),
        "sub_GN": _np(sd["sub_GN"]).reshape(-1),
        "proj_1": _linear(sd, "img_projection.0"),
        "proj_2": _linear(sd, "img_projection.2"),
    }


def convert_phi3_v_state_dict(sd, cfg: "Phi3VConfig" = None) -> dict:
    """Full HF Phi-3-V checkpoint -> Phi3V params: LM trunk via the packed
    qkv/gate_up split (models/phi3.py) + the vision embedding subtree
    (model.vision_embed_tokens.*)."""
    from .phi3 import convert_phi3_state_dict

    cfg = cfg or Phi3VConfig()
    lm = convert_phi3_state_dict(
        {k: v for k, v in sd.items()
         if not k.startswith("model.vision_embed_tokens.")},
        cfg.text,
    )
    vision = convert_phi3v_image_embedding_state_dict(
        sd, prefix="model.vision_embed_tokens."
    )
    return {"language_model": lm, "vision_embed": vision}
