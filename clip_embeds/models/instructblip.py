"""InstructBLIP (FlanT5) generative VQA stack in flax.linen.

JAX equivalent of the reference's InstructBLIP VQAScore path
(t2v_metrics/t2v_metrics/models/vqascore_models/instructblip_model.py:38-48,
63-139 and the vendored lavis blip2_t5_instruct.py): an EVA-style vision
tower feeds a Q-Former whose input is [query tokens; instruction tokens];
the query-slice outputs are projected to the T5 embedding width and prepended
to the T5 encoder's question embeddings; the decoder teacher-forces the
answer and the score is exp(-mean CE) over answer tokens.

Reuses the retrieval stack's vision tower and Q-Former (models/blip2.py) and
the Flan-T5 encoder-decoder (models/t5.py). Weight layout follows HF
``InstructBlipForConditionalGeneration`` so Salesforce instructblip-flan-t5
checkpoints convert directly (core/torch_convert.convert_instructblip_state_dict).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .blip2 import Blip2VisionTower, QFormer, QFormerConfig
from .t5 import T5Config, T5ForConditionalGeneration, shift_right

Dtype = Any


@dataclasses.dataclass(frozen=True)
class InstructBlipConfig:
    # EVA-g defaults (lavis eva_vit.py giant: 1408 wide / 39 layers, mlp 6144)
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=224, patch_size=14, width=1408, layers=39,
            head_width=88, mlp_ratio=6144 / 1408,
        )
    )
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    num_query_tokens: int = 32
    decoder_start_token_id: int = 0
    pad_id: int = 0


class InstructBlipT5(nn.Module):
    cfg: InstructBlipConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant_t5: str = ""  # W8A8 T5 projections: the xxl's 11B T5 drops from
    # ~22 GB bf16 to ~11.2 GB

    def setup(self):
        q = self.cfg.qformer
        self.vision_model = Blip2VisionTower(
            self.cfg.vision, dtype=self.dtype, attn_impl=self.attn_impl
        )
        self.query_tokens = self.param(
            "query_tokens", nn.initializers.zeros,
            (self.cfg.num_query_tokens, q.hidden_size),
        )
        self.word_embeddings = nn.Embed(
            q.vocab_size, q.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="word_embeddings",
        )
        self.position_embeddings = nn.Embed(
            q.max_position_embeddings, q.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="position_embeddings",
        )
        self.qformer = QFormer(q, dtype=self.dtype)
        self.language_projection = nn.Dense(
            self.cfg.t5.d_model, dtype=self.dtype, name="language_projection"
        )
        self.t5 = T5ForConditionalGeneration(self.cfg.t5, dtype=self.dtype,
                                             quant=self.quant_t5)

    def encode_vision(self, pixel_values: jax.Array) -> jax.Array:
        """EVA-g tower only — the TEXT-INDEPENDENT part of the stack. The
        Q-Former conditions on the instruction (which carries the candidate
        text in VQAScore templates), so unlike CLIP-FlanT5 only the vision
        tower is cacheable per image in the m x n broadcast — but at
        EVA-g scale (39 layers x 1408) that is the single largest
        per-pair FLOPs block the reference re-runs per (image, text)
        (instructblip_model.py:80-105)."""
        return self.vision_model(pixel_values)

    def query_features(
        self,
        pixel_values: jax.Array,                 # [B, S, S, 3]
        qformer_input_ids: jax.Array,            # [B, Tq] instruction tokens
        qformer_attention_mask: Optional[jax.Array] = None,  # bool [B, Tq]
    ) -> jax.Array:
        """Projected query outputs [B, Q, d_model] for the T5 encoder prefix
        (instructblip_model.py:80-105: queries + instruction text through the
        Q-Former with image cross-attention, t5_proj of the query slice)."""
        return self.query_features_from_embeds(
            self.vision_model(pixel_values), qformer_input_ids,
            qformer_attention_mask,
        )

    def query_features_from_embeds(
        self,
        image_embeds: jax.Array,                 # [B, N, W] cached tower out
        qformer_input_ids: jax.Array,            # [B, Tq]
        qformer_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        b = image_embeds.shape[0]
        nq = self.cfg.num_query_tokens
        queries = jnp.broadcast_to(
            self.query_tokens[None].astype(self.dtype),
            (b, nq, self.query_tokens.shape[-1]),
        )
        t = qformer_input_ids.shape[1]
        pos = self.position_embeddings(jnp.arange(t))[None]
        text = self.word_embeddings(qformer_input_ids) + pos.astype(self.dtype)
        hidden = jnp.concatenate([queries, text], axis=1)
        if qformer_attention_mask is None:
            qformer_attention_mask = jnp.ones((b, t), bool)
        mask = jnp.concatenate(
            [jnp.ones((b, nq), bool), qformer_attention_mask.astype(bool)],
            axis=1,
        )
        out = self.qformer(hidden, image_embeds, mask, query_length=nq)
        return self.language_projection(out[:, :nq])

    def __call__(
        self,
        pixel_values: jax.Array,                 # [B, S, S, 3]
        qformer_input_ids: jax.Array,            # [B, Tq]
        input_ids: jax.Array,                    # [B, L] T5 question tokens
        labels: jax.Array,                       # [B, T] answer (-100 pads)
        qformer_attention_mask: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,        # bool [B, L]
        decoder_attention_mask: Optional[jax.Array] = None,  # bool [B, T]
    ) -> jax.Array:
        """Decoder logits [B, T, vocab] teacher-forced on shift_right(labels)
        (instructblip_model.py:124-133: encoder embeds = [query prefix;
        question embeds], labels mask pads with -100)."""
        return self.forward_with_vision(
            self.vision_model(pixel_values), qformer_input_ids, input_ids,
            labels, qformer_attention_mask, attention_mask,
            decoder_attention_mask,
        )

    def forward_with_vision(
        self,
        image_embeds: jax.Array,                 # [B, N, W] cached tower out
        qformer_input_ids: jax.Array,
        input_ids: jax.Array,
        labels: jax.Array,
        qformer_attention_mask: Optional[jax.Array] = None,
        attention_mask: Optional[jax.Array] = None,
        decoder_attention_mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        """``__call__`` with a PRECOMPUTED vision-tower output: the m x n
        VQAScore broadcast runs the EVA-g tower once per image and replays
        its embeddings across the n candidate texts (the Q-Former + T5 still
        run per pair — they condition on the text)."""
        prefix = self.query_features_from_embeds(
            image_embeds, qformer_input_ids, qformer_attention_mask
        )
        b, nq = prefix.shape[:2]
        text_embeds = self.t5.shared(jnp.where(input_ids < 0, 0, input_ids))
        inputs_embeds = jnp.concatenate([prefix, text_embeds], axis=1)
        if attention_mask is None:
            attention_mask = jnp.ones(input_ids.shape, bool)
        enc_mask = jnp.concatenate(
            [jnp.ones((b, nq), bool), attention_mask.astype(bool)], axis=1
        )
        decoder_input_ids = shift_right(
            labels, self.cfg.decoder_start_token_id, self.cfg.pad_id
        )
        enc = self.t5.encode(inputs_embeds=inputs_embeds,
                             attention_mask=enc_mask)
        return self.t5.decode(
            decoder_input_ids, enc, decoder_attention_mask, enc_mask
        )
