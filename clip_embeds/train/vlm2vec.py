"""VLM2Vec embedding training: LoRA + contrastive loss + GradCache.

Reference: VLM2Vec/train.py + src/trainer.py (GradCacheTrainer) + src/loss.py
DistributedContrastiveLoss (T=0.02). The run recipe (scripts/llava_1.5/
run_train.sh:3-15): bs 64/GPU, grad_cache chunk 1, lr 2e-5 linear, 1000 steps.
Here the trainable state is the LoRA adapter tree; the frozen LLaVA base rides
under stop_gradient inside ``materialize``, and GradCache chunks the encoder
passes (train/grad_cache.py) exactly like the torch 2-pass engine.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from ..losses.clip_loss import embedding_contrastive_loss
from ..models.llava import Llava
from ..models.lora import materialize, normalize_lora, to_collection
from .grad_cache import cache_grad_step
from .steps import TrainState


def make_vlm2vec_train_step(
    model: Llava,
    base_params: Any,
    lora_alpha: float = 16.0,
    temperature: float = 0.02,
    grad_cache_chunks: int = 0,
    bidirectional: bool = False,
) -> Callable[[TrainState, Dict[str, jax.Array]], Tuple[TrainState, Dict]]:
    """Train step over a LoRA adapter tree.

    batch: qry_ids/qry_mask/qry_pixels + tgt_ids/tgt_mask (data/mmeb.py).

    Two adapter application modes, keyed off the model:
      * ``model.lora_rank == 0`` (default): ``materialize`` adds the deltas
        onto (stop-gradient) copies of the targeted base kernels. Simple,
        but the delta-added kernels are a SECOND near-full weight tree —
        at 7B that is ~13.5 + ~12.5 GB.
      * ``model.lora_rank > 0``: unmaterialized side-path — the base
        kernels (fp OR W8A8 int8) stay untouched and each targeted Dense
        adds ``scale*(x@A)@B`` (quant.py _lora_delta). The QLoRA-shaped
        single-chip recipe: frozen int8 trunk (~6.9 GB) + fp32 adapters.
        ``state.params`` stays the flat canonical adapter tree either way
        (same npz export/eval handoff); it is restructured into the flax
        'lora' collection inside the step (pure tree reshaping, free
        under jit).
    """
    unmaterialized = getattr(model, "lora_rank", 0) > 0

    def encode(lora, batch):
        if unmaterialized:
            variables = {
                "params": base_params,
                "lora": to_collection(normalize_lora(lora)),
            }
        else:
            variables = {
                "params": materialize(
                    base_params, lora, lora_alpha, train=True)
            }
        qry = model.apply(
            variables, batch["qry_ids"], batch["qry_pixels"],
            batch["qry_mask"], method="embed_last_token",
        )
        tgt = model.apply(
            variables, batch["tgt_ids"], None, batch["tgt_mask"],
            method="embed_last_token",
        )
        return {"qry": qry, "tgt": tgt}

    return _make_step(encode, temperature, bidirectional, grad_cache_chunks)


def make_vlm2vec_mixed_train_step(
    model: Llava,
    base_params: Any = None,
    lora_alpha: float = 16.0,
    temperature: float = 0.02,
    grad_cache_chunks: int = 0,
    bidirectional: bool = False,
) -> Callable[[TrainState, Dict[str, jax.Array]], Tuple[TrainState, Dict]]:
    """Train step over MMEB mixed image/text batches: any row on EITHER side
    may or may not carry an image (data/mmeb.py mixed_pair_batches — the
    static-shape equivalent of the reference's image_mask collator split,
    src/collator.py:12-85 / trainer.py:54-89). Each side pools through
    ``Llava.embed_mixed``.

    ``base_params`` set -> ``state.params`` is a LoRA adapter tree over the
    frozen base (the reference recipe, src/model.py:97-116);
    ``base_params=None`` -> ``state.params`` IS the full parameter tree
    (full finetune).

    batch keys per side: {qry,tgt}_ids/_mask/_pixels/_image_valid.

    ``model.lora_rank > 0`` selects the unmaterialized adapter side-path
    (see make_vlm2vec_train_step) — requires ``base_params``.
    """
    unmaterialized = getattr(model, "lora_rank", 0) > 0
    if unmaterialized and base_params is None:
        raise ValueError("model.lora_rank > 0 requires base_params")

    def encode(trainable, batch):
        if unmaterialized:
            variables = {
                "params": base_params,
                "lora": to_collection(normalize_lora(trainable)),
            }
        elif base_params is not None:
            variables = {"params": materialize(
                base_params, trainable, lora_alpha, train=True)}
        else:
            variables = {"params": trainable}

        def side(prefix: str):
            return model.apply(
                variables,
                batch[f"{prefix}_ids"],
                batch[f"{prefix}_pixels"],
                batch[f"{prefix}_image_valid"],
                batch[f"{prefix}_mask"],
                method="embed_mixed",
            )

        return {"qry": side("qry"), "tgt": side("tgt")}

    return _make_step(encode, temperature, bidirectional, grad_cache_chunks)


def _make_step(encode, temperature, bidirectional, grad_cache_chunks):
    def rep_loss(reps):
        loss = embedding_contrastive_loss(
            reps["qry"], reps["tgt"], temperature
        )
        if bidirectional:
            loss = (loss + embedding_contrastive_loss(
                reps["tgt"], reps["qry"], temperature
            )) / 2
        return loss

    def train_step(state: TrainState, batch):
        if grad_cache_chunks > 1:
            loss, grads = cache_grad_step(
                encode, rep_loss, state.params, batch, grad_cache_chunks
            )
        else:
            loss, grads = jax.value_and_grad(
                lambda trainable: rep_loss(encode(trainable, batch))
            )(state.params)
        state = state.apply_gradients(grads)
        return state, {"loss": loss}

    return train_step
