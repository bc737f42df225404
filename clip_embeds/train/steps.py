"""pjit training steps for CLIP-style contrastive training.

The hot loop equivalent of the reference train_one_epoch
(open_clip/src/open_clip_train/train.py:64-248): forward both towers, global
contrastive loss, AdamW update, logit-scale clamp to ln(100) (train.py:187-189).
Under a data-sharded mesh the same jitted function runs 1..N chips; XLA inserts
the feature all-gathers (SURVEY.md §2e). No GradScaler — bf16 needs none
(reference precision.py is CUDA AMP machinery).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from .._vendor.flax import struct

from ..losses.clip_loss import (
    clip_loss,
    clip_loss_hard_text,
    clip_metrics,
    distill_clip_loss,
)
from ..losses.siglip import siglip_loss
from .grad_cache import cache_grad_step

LOGIT_SCALE_MAX = 4.6052  # ln(100)


class TrainState(struct.PyTreeNode):
    step: jax.Array
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation = struct.field(pytree_node=False)

    @classmethod
    def create(cls, params, tx):
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            opt_state=tx.init(params),
            tx=tx,
        )

    def apply_gradients(self, grads):
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        params = optax.apply_updates(self.params, updates)
        return self.replace(step=self.step + 1, params=params, opt_state=opt_state)


def _clamp_logit_scale(params):
    if "logit_scale" in params:
        params = dict(params)
        params["logit_scale"] = jnp.clip(params["logit_scale"], None, LOGIT_SCALE_MAX)
    return params


def make_clip_train_step(
    model,
    use_siglip: bool = False,
    use_hard_text: bool = False,
    grad_cache_chunks: int = 0,
    seed: int = 0,
) -> Callable[[TrainState, Dict[str, jax.Array]], Tuple[TrainState, Dict]]:
    """Build a jittable CLIP train step.

    batch keys: 'images' [B,H,W,3], 'texts' [B,ctx]; with use_hard_text also
    'hard_texts' [H,ctx] and optional 'hard_valid' [H] bool.
    """

    # FLIP patch dropout is a train-time behavior: the step passes
    # deterministic=False plus a per-step rng so eval/serving paths stay
    # byte-stable (reference transformer.py PatchDropout is train-only).
    use_patch_dropout = (
        getattr(model.cfg.vision, "patch_dropout", 0.0) > 0.0
        and model.cfg.vision.tower == "vit"
    )

    def compute_loss(params, batch, rngs=None):
        out = model.apply(
            {"params": params}, batch["images"], batch["texts"],
            deterministic=not use_patch_dropout, rngs=rngs,
        )
        img, txt = out["image_features"], out["text_features"]
        scale = out["logit_scale"]
        bias = out.get("logit_bias")
        if use_hard_text:
            hard = model.apply(
                {"params": params}, batch["hard_texts"],
                normalize=True, method="encode_text",
            )
            loss = clip_loss_hard_text(
                img, txt, hard, scale, hard_valid=batch.get("hard_valid")
            )
        elif use_siglip:
            loss = siglip_loss(img, txt, scale, bias)
        else:
            loss = clip_loss(img, txt, scale, bias)
        metrics = clip_metrics(img, txt, scale)
        metrics["logit_scale"] = scale
        return loss, metrics

    def encode(params, chunk):
        out = model.apply({"params": params}, chunk["images"], chunk["texts"])
        return {"img": out["image_features"], "txt": out["text_features"]}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if grad_cache_chunks > 1:
            scale = jnp.exp(state.params["logit_scale"])

            def rep_loss(reps):
                return clip_loss(reps["img"], reps["txt"], scale)

            loss, grads = cache_grad_step(
                encode, rep_loss, state.params, batch, grad_cache_chunks
            )
            metrics = {"logit_scale": scale}
        else:
            rngs = None
            if use_patch_dropout:
                rngs = {"patch_dropout": jax.random.fold_in(
                    jax.random.PRNGKey(seed), state.step)}
            (loss, metrics), grads = jax.value_and_grad(
                compute_loss, has_aux=True
            )(state.params, batch, rngs)
        state = state.apply_gradients(grads)
        state = state.replace(params=_clamp_logit_scale(state.params))
        metrics = dict(metrics, loss=loss)
        return state, metrics

    return train_step


def make_coca_train_step(
    model,
    caption_loss_weight: float = 2.0,
    clip_loss_weight: float = 1.0,
) -> Callable[[TrainState, Dict[str, jax.Array]], Tuple[TrainState, Dict]]:
    """CoCa training step: contrastive + teacher-forced captioning loss
    (reference coca training through CoCaLoss, loss.py:179-238, weights via
    --coca-caption-loss-weight / --coca-contrastive-loss-weight)."""
    from ..losses.coca import coca_loss

    def compute_loss(params, batch):
        out = model.apply({"params": params}, batch["images"], batch["texts"])
        losses = coca_loss(
            out, caption_loss_weight, clip_loss_weight,
            pad_id=model.cfg.pad_id,
        )
        metrics = {
            "contrastive_loss": losses["contrastive_loss"],
            "caption_loss": losses["caption_loss"],
            "logit_scale": out["logit_scale"],
        }
        return losses["loss"], metrics

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        (loss, metrics), grads = jax.value_and_grad(
            compute_loss, has_aux=True
        )(state.params, batch)
        state = state.apply_gradients(grads)
        state = state.replace(params=_clamp_logit_scale(state.params))
        return state, dict(metrics, loss=loss)

    return train_step


def make_distill_train_step(
    model,
    teacher_model,
) -> Callable[[TrainState, Any, Dict[str, jax.Array]], Tuple[TrainState, Dict]]:
    """--distill training step (reference main.py:208-248 + train.py:70-107):
    the frozen teacher forwards the same batch under no-grad, the student
    optimizes contrastive + KD loss (DistillClipLoss, loss.py:241-277).

    step(state, teacher_params, batch) — teacher params stay outside the
    TrainState so they are never donated or updated.
    """

    def compute_loss(params, teacher_params, batch):
        out = model.apply({"params": params}, batch["images"], batch["texts"])
        t_out = jax.lax.stop_gradient(
            teacher_model.apply(
                {"params": teacher_params}, batch["images"], batch["texts"]
            )
        )
        contrastive, distill = distill_clip_loss(
            out["image_features"], out["text_features"], out["logit_scale"],
            t_out["image_features"], t_out["text_features"],
            t_out["logit_scale"],
        )
        metrics = clip_metrics(
            out["image_features"], out["text_features"], out["logit_scale"]
        )
        metrics.update(
            contrastive_loss=contrastive, distill_loss=distill,
            logit_scale=out["logit_scale"],
        )
        # total_loss = sum of the loss dict (reference train.py:124-129)
        return contrastive + distill, metrics

    def train_step(state: TrainState, teacher_params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            compute_loss, has_aux=True
        )(state.params, teacher_params, batch)
        state = state.apply_gradients(grads)
        state = state.replace(params=_clamp_logit_scale(state.params))
        return state, dict(metrics, loss=loss)

    return train_step


def make_frozen_tower_train_step(
    loss_of_params: Callable[[Any, Any, Dict], Tuple[jax.Array, Dict]],
) -> Callable:
    """Train step where only a head subtree is trainable (PACL/SPARC pattern:
    frozen CLIP tower under stop_gradient, trainable projections —
    reference train_pacl.py / pacl.py:97).

    loss_of_params(trainable, frozen, batch) -> (loss, metrics)
    """

    def train_step(state: TrainState, frozen_params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            loss_of_params, has_aux=True
        )(state.params, frozen_params, batch)
        state = state.apply_gradients(grads)
        return state, dict(metrics, loss=loss)

    return train_step
