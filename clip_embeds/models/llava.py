"""LLaVA-1.5: CLIP vision tower + MLP projector + Llama decoder.

Reference behaviours reproduced:
* vision features from hidden_states[-2] with CLS handling
  ``feature_select in {'patch', 'cls_patch', 'cls'}`` (the 'cls' mode is
  paper-added — t2v_metrics llava clip_encoder.py:29-38; VLM2Vec
  llava_15/modeling_llava.py:277-304)
* 2-layer GELU mm_projector (llava_arch.py:91-94 encode_images)
* image-token splice at IMAGE_TOKEN_INDEX = -200
  (llava_arch.py:96-200 prepare_inputs_labels_for_multimodal) — redesigned
  with static shapes: one sentinel per sample expands to a fixed n_image
  block via a vectorized gather (SURVEY.md §7 "static-shape variant")
* VLM2Vec last-token pooling + L2 norm (VLM2Vec/src/model.py:42-52)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .layers import exact_gelu
from .llama import LlamaConfig, LlamaForCausalLM
from .vit import VisionTransformer

Dtype = Any

IMAGE_TOKEN_INDEX = -200
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    feature_layer: int = -2
    feature_select: str = "patch"  # 'patch' | 'cls_patch' | 'cls'
    vision_quick_gelu: bool = True  # openai CLIP-ViT-L-336 tower

    @property
    def n_image_tokens(self) -> int:
        n = self.vision.num_patches
        if self.feature_select == "cls_patch":
            return n + 1
        if self.feature_select == "cls":
            return 1
        return n


def llava_tiny_config() -> LlavaConfig:
    from .llama import llama_tiny_config

    return LlavaConfig(
        llama=llama_tiny_config(),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )


def splice_positions(
    input_ids: jax.Array, n_image: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Index maps for expanding one image sentinel into n_image slots.

    Returns (image_pos [B], out_is_image [B,F], text_gather [B,F],
    image_gather [B,F]) where F = L - 1 + n_image.
    """
    b, l = input_ids.shape
    final_len = l - 1 + n_image
    image_pos = jnp.argmax(input_ids == IMAGE_TOKEN_INDEX, axis=1)  # [B]
    j = jnp.broadcast_to(jnp.arange(final_len)[None, :], (b, final_len))
    p = image_pos[:, None]
    is_image = (j >= p) & (j < p + n_image)
    text_gather = jnp.where(j < p, j, jnp.clip(j - n_image + 1, 0, l - 1))
    image_gather = jnp.clip(j - p, 0, n_image - 1)
    return image_pos, is_image, text_gather, image_gather


def expand_like_tokens(
    values: jax.Array, input_ids: jax.Array, n_image: int, image_fill
) -> jax.Array:
    """Expand a per-token array (labels / attention mask) to the spliced
    length, filling image slots with ``image_fill``."""
    _, is_image, text_gather, _ = splice_positions(input_ids, n_image)
    gathered = jnp.take_along_axis(values, text_gather, axis=1)
    return jnp.where(is_image, image_fill, gathered)


def extract_prefix_kv(kv_vars, num_layers: int):
    """Prefix KV from the 'kv' collection sown by ``Llava.prefill``
    (apply(..., mutable=['kv'])[1]['kv']): per-layer ((k, v), ...) for the
    unrolled trunk, or stacked ([L,...] K, V) for scan_layers."""
    tree = kv_vars["language_model"]["model"]
    if "blocks" in tree:  # scan_layers: flax stacked the sown KV on axis 0
        node = tree["blocks"]["self_attn"]
        return (node["k"][0], node["v"][0])
    return tuple(
        (tree[f"layers_{i}"]["self_attn"]["k"][0],
         tree[f"layers_{i}"]["self_attn"]["v"][0])
        for i in range(num_layers)
    )


def stack_llava_params(params: dict) -> dict:
    """Unrolled Llava params -> scan_llm layout (the Llama trunk's blocks
    stacked; vision tower / projector unchanged)."""
    from .llama import stack_llama_params

    out = dict(params)
    out["language_model"] = stack_llama_params(params["language_model"])
    return out


class MultiModalProjector(nn.Module):
    hidden_size: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = nn.Dense(self.hidden_size, dtype=self.dtype, name="linear_1")(x)
        x = exact_gelu(x)
        return nn.Dense(self.hidden_size, dtype=self.dtype, name="linear_2")(x)


class Llava(nn.Module):
    cfg: LlavaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant_llm: str = ""  # W8A8 trunk projections ('' | 'dynamic' | 'static')
    lora_rank: int = 0  # unmaterialized LoRA over the trunk projections
    # (q/k/v/o/gate/up/down; vision tower excluded like the reference's
    # exclude_modules='.*vision_tower.*', VLM2Vec/src/model.py:114). The
    # adapters ride in the flax 'lora' collection — pass
    # {'params': base, 'lora': models.lora.to_collection(flat_lora)} to
    # apply(); the base kernels (fp OR int8) are never rewritten, so a
    # QLoRA-shaped recipe (frozen W8A8 trunk + fp32 adapters) trains in
    # ~7 GB instead of materialize()'s ~26 GB.
    lora_alpha: float = 16.0
    scan_llm: bool = False  # lax.scan trunk (stack_llava_params layout):
    # 32x smaller HLO for the 7B — compiles in a fraction of the unrolled
    # time

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
        self.language_model = LlamaForCausalLM(
            self.cfg.llama, dtype=self.dtype, attn_impl=self.attn_impl,
            remat=self.remat, quant=self.quant_llm,
            lora_rank=self.lora_rank, lora_alpha=self.lora_alpha,
            scan_layers=self.scan_llm,
        )

    def encode_images(self, pixel_values: jax.Array) -> jax.Array:
        """[B, S, S, 3] -> projected image tokens [B, n_image, hidden]."""
        hidden = self.vision_tower(
            pixel_values, hidden_layer=self.cfg.feature_layer
        )
        if self.cfg.feature_select == "patch":
            feats = hidden[:, 1:]
        elif self.cfg.feature_select == "cls_patch":
            feats = hidden
        elif self.cfg.feature_select == "cls":
            feats = hidden[:, :1]
        else:
            raise ValueError(self.cfg.feature_select)
        return self.multi_modal_projector(feats)

    def merge(
        self, input_ids: jax.Array, image_features: jax.Array
    ) -> jax.Array:
        """Embed text and splice image features at the sentinel."""
        n_image = image_features.shape[1]
        safe_ids = jnp.where(input_ids < 0, 0, input_ids)
        text_embeds = self.language_model.embed(safe_ids)
        _, is_image, text_gather, image_gather = splice_positions(
            input_ids, n_image
        )
        text_part = jnp.take_along_axis(
            text_embeds, text_gather[..., None], axis=1
        )
        image_part = jnp.take_along_axis(
            image_features, image_gather[..., None], axis=1
        )
        return jnp.where(is_image[..., None], image_part, text_part)

    def __call__(
        self,
        input_ids: jax.Array,          # [B, L] with one IMAGE_TOKEN_INDEX each
        pixel_values: jax.Array,       # [B, S, S, 3]
        attention_mask: Optional[jax.Array] = None,  # bool [B, L]
    ) -> jax.Array:
        """Logits [B, L - 1 + n_image, vocab]."""
        image_features = self.encode_images(pixel_values)
        embeds = self.merge(input_ids, image_features)
        mask = None
        if attention_mask is not None:
            mask = expand_like_tokens(
                attention_mask.astype(jnp.int32), input_ids,
                image_features.shape[1], 1,
            ).astype(bool)
        hidden = self.language_model.trunk(embeds, mask)
        return self.language_model.logits(hidden)

    def prefill(
        self,
        input_ids: jax.Array,       # [1, Lp] shared prefix w/ image sentinel,
                                    # right-padded; real length = prefix_valid
        pixel_values: jax.Array,    # [1, S, S, 3]
        prefix_valid: Optional[jax.Array] = None,  # bool [1, Lp]
    ) -> jax.Array:
        """Run the shared image+question prefix once, sowing per-layer
        post-RoPE K/V into the 'kv' collection (apply with mutable=['kv'],
        then ``extract_prefix_kv``).

        Redesign of the reference's m x n VQAScore broadcast
        (t2v_metrics score.py:43-57 repeats the image per text and re-runs
        the FULL forward per pair, llava_model.py:289-370): the image tokens
        and the common question prefix are text-independent, so their KV is
        computed once per image and replayed across all n candidate texts via
        ``suffix_logits``. Returns the expanded-length validity mask
        [1, F = Lp - 1 + n_image] to pass as the suffix pass's prefix mask.
        """
        image_features = self.encode_images(pixel_values)
        embeds = self.merge(input_ids, image_features)
        if prefix_valid is None:
            prefix_valid = jnp.ones_like(input_ids, bool)
        mask = expand_like_tokens(
            prefix_valid.astype(jnp.int32), input_ids,
            image_features.shape[1], 1,
        ).astype(bool)
        # no attention mask: the padding is strictly trailing, so causal
        # attention already keeps real positions pad-free — and a mask-free
        # prefill needs no bias in the fused attention kernel. Pad positions
        # sow garbage KV; the suffix pass masks them via the returned mask.
        self.language_model.trunk(embeds, None, sow_kv=True)
        return mask

    def suffix_logits(
        self,
        suffix_ids: jax.Array,      # [n, Ls] right-padded candidate suffixes
        prefix_kv,                  # per-layer ((k, v), ...) at batch 1
        prefix_mask: jax.Array,     # bool [Bp, F] from prefill
        suffix_mask: jax.Array,     # bool [n, Ls]
        prefix_len: jax.Array,      # REAL (unpadded) prefix length — scalar
                                    # (shared prefix) or [n] (per-row, for a
                                    # BATCHED prefill of distinct images)
        suffix_block: Optional[int] = None,  # if set, each row holds
                                    # n_texts candidate suffixes of this
                                    # width CONCATENATED; they attend
                                    # block-diagonally and all read the
                                    # row's prefix KV (no KV replication)
    ) -> jax.Array:
        """Candidate-text logits [n, Ls, vocab] against a cached prefix."""
        embeds = self.language_model.embed(
            jnp.where(suffix_ids < 0, 0, suffix_ids)
        )
        n, ls = suffix_ids.shape
        base = jnp.asarray(prefix_len, jnp.int32)
        if base.ndim == 0:
            base = jnp.broadcast_to(base, (n,))
        offsets = jnp.arange(ls)
        if suffix_block is not None:
            offsets = offsets % suffix_block  # positions restart per text
        positions = base[:, None] + offsets[None, :]
        hidden = self.language_model.trunk(
            embeds, suffix_mask, positions, prefix_kv=prefix_kv,
            prefix_mask=prefix_mask, suffix_block=suffix_block,
        )
        return self.language_model.logits(hidden)

    def embed_mixed(
        self,
        input_ids: jax.Array,        # [B, L]: every row has ONE sentinel —
                                     # imageless rows carry it in the pad area
        pixel_values: jax.Array,     # [B, S, S, 3] (zeros for imageless rows)
        image_valid: jax.Array,      # bool [B]: row actually has an image
        attention_mask: jax.Array,   # bool [B, L] over the REAL text tokens
    ) -> jax.Array:
        """VLM2Vec mixed image/text batch pooling — the static-shape
        equivalent of the reference's image_mask row split
        (src/collator.py:12-85, trainer.py:54-89 split_vlm_inputs): the image
        block of imageless rows is masked out of attention and RoPE positions
        are re-derived as cumsum(mask)-1, so their valid tokens see exactly
        the text-only layout."""
        image_features = self.encode_images(pixel_values)
        n_image = image_features.shape[1]
        embeds = self.merge(input_ids, image_features)
        _, is_image, text_gather, image_gather = splice_positions(
            input_ids, n_image
        )
        text_mask = jnp.take_along_axis(
            attention_mask.astype(jnp.int32), text_gather, axis=1
        )
        mask = jnp.where(is_image, image_valid[:, None].astype(jnp.int32),
                         text_mask)
        positions = jnp.maximum(jnp.cumsum(mask, axis=1) - 1, 0)
        hidden = self.language_model.trunk(
            embeds, mask.astype(bool), positions
        )
        idx = jnp.arange(hidden.shape[1])[None, :]
        last = jnp.max(jnp.where(mask.astype(bool), idx, -1), axis=1)
        pooled = jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0]
        return l2_normalize(pooled)

    def embed_last_token(
        self,
        input_ids: jax.Array,
        pixel_values: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """VLM2Vec pooling: last valid token's hidden state, L2-normalized
        (MMEBModel._pooling, VLM2Vec/src/model.py:42-52)."""
        if pixel_values is not None:
            image_features = self.encode_images(pixel_values)
            n_image = image_features.shape[1]
            embeds = self.merge(input_ids, image_features)
            if attention_mask is None:
                attention_mask = jnp.ones_like(input_ids, jnp.int32)
            mask = expand_like_tokens(
                attention_mask.astype(jnp.int32), input_ids, n_image, 1
            )
        else:
            embeds = self.language_model.embed(
                jnp.where(input_ids < 0, 0, input_ids)
            )
            mask = (
                attention_mask.astype(jnp.int32)
                if attention_mask is not None
                else jnp.ones_like(input_ids, jnp.int32)
            )
        hidden = self.language_model.trunk(embeds, mask.astype(bool))
        last = jnp.sum(mask, axis=1) - 1
        pooled = jnp.take_along_axis(hidden, last[:, None, None], axis=1)[:, 0]
        return l2_normalize(pooled)
