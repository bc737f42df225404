"""CLIP-FlanT5: CLIP vision tower + projector + T5 encoder-decoder.

Reference: t2v_metrics/t2v_metrics/models/vqascore_models/clip_t5/ — llava-
style vision features (hidden_states[-2], patch select, 2-layer projector)
spliced into the *encoder* input embeddings at the image sentinel; the decoder
teacher-forces the answer. This is the backbone of the default VQAScore model
(clip-flant5-xxl).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .llava import IGNORE_INDEX, IMAGE_TOKEN_INDEX, MultiModalProjector, splice_positions, expand_like_tokens
from .t5 import T5Config, T5ForConditionalGeneration, shift_right
from .vit import VisionTransformer

Dtype = Any


@dataclasses.dataclass(frozen=True)
class CLIPT5Config:
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    feature_layer: int = -2
    feature_select: str = "patch"
    vision_quick_gelu: bool = True
    decoder_start_token_id: int = 0
    pad_id: int = 0

    @property
    def n_image_tokens(self) -> int:
        n = self.vision.num_patches
        if self.feature_select == "cls_patch":
            return n + 1
        if self.feature_select == "cls":
            return 1
        return n


class CLIPT5(nn.Module):
    cfg: CLIPT5Config
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant_t5: str = ""  # W8A8 T5 projections ('' | 'dynamic' | 'static');
    # the vision tower stays fp (its cost amortizes across texts via
    # encode_images reuse — see scores/vqa_score.py T5VQAScorer)

    def setup(self):
        self.vision_tower = VisionTransformer(
            self.cfg.vision, embed_dim=self.cfg.t5.d_model,
            quick_gelu=self.cfg.vision_quick_gelu, dtype=self.dtype,
            attn_impl=self.attn_impl, remat=self.remat,
        )
        self.multi_modal_projector = MultiModalProjector(
            self.cfg.t5.d_model, dtype=self.dtype
        )
        self.t5 = T5ForConditionalGeneration(self.cfg.t5, dtype=self.dtype,
                                             quant=self.quant_t5)

    def encode_images(self, pixel_values: jax.Array) -> jax.Array:
        hidden = self.vision_tower(
            pixel_values, hidden_layer=self.cfg.feature_layer
        )
        if self.cfg.feature_select == "patch":
            feats = hidden[:, 1:]
        elif self.cfg.feature_select == "cls_patch":
            feats = hidden
        else:
            feats = hidden[:, :1]
        return self.multi_modal_projector(feats)

    def __call__(
        self,
        input_ids: jax.Array,                # [B, L] with one sentinel
        pixel_values: jax.Array,             # [B, S, S, 3]
        labels: jax.Array,                   # [B, T] with IGNORE_INDEX pads
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Decoder logits [B, T, vocab] teacher-forced on shift_right(labels)."""
        return self.forward_with_features(
            input_ids, self.encode_images(pixel_values), labels,
            attention_mask, decoder_attention_mask,
        )

    def forward_with_features(
        self,
        input_ids: jax.Array,                # [B, L] with one sentinel
        image_features: jax.Array,           # [B, n_image, d_model]
        labels: jax.Array,                   # [B, T] with IGNORE_INDEX pads
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """Same as ``__call__`` but with PRECOMPUTED image features.

        Vision-reuse VQAScore split: the CLIP tower + projector output is
        text-independent, so the m x n broadcast encodes each image ONCE
        (``encode_images``) and splices the cached features into the n
        per-text encoder inputs — the reference re-runs the full vision
        tower per (image, text) pair (t2v_metrics clip_t5_model.py:220-281).
        The T5 encoder itself is bidirectional (every position attends to
        the question text), so unlike the LLaVA KV-prefix path nothing
        further is reusable across texts."""
        n_image = image_features.shape[1]
        safe_ids = jnp.where(input_ids < 0, 0, input_ids)
        text_embeds = self.t5.shared(safe_ids)
        _, is_image, text_gather, image_gather = splice_positions(
            input_ids, n_image
        )
        text_part = jnp.take_along_axis(text_embeds, text_gather[..., None], axis=1)
        image_part = jnp.take_along_axis(
            image_features, image_gather[..., None], axis=1
        )
        inputs_embeds = jnp.where(is_image[..., None], image_part, text_part)

        enc_mask = None
        if attention_mask is not None:
            enc_mask = expand_like_tokens(
                attention_mask.astype(jnp.int32), input_ids, n_image, 1
            ).astype(bool)

        decoder_input_ids = shift_right(
            labels, self.cfg.decoder_start_token_id, self.cfg.pad_id
        )
        enc = self.t5.encode(inputs_embeds=inputs_embeds,
                             attention_mask=enc_mask)
        return self.t5.decode(
            decoder_input_ids, enc, decoder_attention_mask, enc_mask
        )
