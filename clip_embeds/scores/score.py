"""Public Score API: m x n (images x texts) scoring + dataset batch_forward.

Reference: t2v_metrics/t2v_metrics/score.py:13-92 — ``Score(images, texts)``
returns an m x n matrix by pairing each image with every text;
``batch_forward`` runs a dataset of {'images': [k], 'texts': [l]} dicts to a
[N, k, l] tensor. Pair models (VQAScore) score (image, text) pairs; embedding
models (CLIPScore/ITMScore-style) factorize through embeddings.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np

from ..image.preprocess import ImageLike

ImageTextDict = Dict[str, List]
PairForwardFn = Callable[[Sequence[ImageLike], Sequence[str]], np.ndarray]


class Score:
    """Wraps a pair-scoring function f(images, texts) -> [n] into the m x n API.

    ``image_texts_forward(image, texts, **kw) -> [n]``, when provided, takes
    the m x n broadcast instead of the pair loop — VQA scorers use it to
    encode each image (and the shared prompt prefix) ONCE and replay the
    cached KV across the n candidate texts, instead of the reference's
    full re-forward per (image, text) pair (score.py:43-57).
    """

    def __init__(self, pair_forward: PairForwardFn,
                 image_texts_forward=None, groups_forward=None,
                 group_size: int = 8):
        self.pair_forward = pair_forward
        self.image_texts_forward = image_texts_forward
        # groups_forward(images[k], texts[k][n], **kw) -> [k, n]: one
        # batched prefill + one block-causal concatenated-suffix pass per
        # k-group (two dispatches per k images instead of two per image)
        self.groups_forward = groups_forward
        # k per group. The prefix KV is the memory cost that scales with
        # k: at llava-v1.5-7b shapes each image holds ~327 MB of bf16 KV
        # (32 layers x 2 x ~640 tokens x 4096 x 2B), so k=8 is ~2.6 GB.
        self.group_size = group_size

    def __call__(
        self,
        images: Union[ImageLike, Sequence[ImageLike]],
        texts: Union[str, Sequence[str]],
        **kwargs,
    ) -> np.ndarray:
        if isinstance(images, (str,)) or not isinstance(images, (list, tuple)):
            images = [images]
        if isinstance(texts, str):
            texts = [texts]
        scores = np.zeros((len(images), len(texts)), np.float32)
        if (self.groups_forward is not None and len(texts) > 1
                and len(images) > 1):
            # the m x n broadcast IS a k-group (every image scores the same
            # n texts): one batched prefill + one concatenated-suffix pass
            # per group_size images instead of two dispatches per image
            bs = self.group_size
            for start in range(0, len(images), bs):
                chunk = list(images[start : start + bs])
                scores[start : start + len(chunk)] = self.groups_forward(
                    chunk, [list(texts)] * len(chunk), **kwargs
                )
            return scores
        if self.image_texts_forward is not None and len(texts) > 1:
            for i, image in enumerate(images):
                scores[i] = self.image_texts_forward(image, list(texts),
                                                     **kwargs)
            return scores
        for i, image in enumerate(images):
            scores[i] = self.pair_forward([image] * len(texts), list(texts), **kwargs)
        return scores

    forward = __call__

    def batch_forward(
        self, dataset: List[ImageTextDict], batch_size: int = 16, **kwargs
    ) -> np.ndarray:
        """[N, n_images_per_sample, n_texts_per_sample] (score.py:59-92).

        With a grouped scorer, each (sample, image) row scores its sample's
        n texts against ONE image encode + prefix prefill (Winoground-style
        2x2 datasets re-encode nothing per text)."""
        n = len(dataset)
        n_images = len(dataset[0]["images"])
        n_texts = len(dataset[0]["texts"])
        out = np.zeros((n, n_images, n_texts), np.float32)
        if self.groups_forward is not None and n_texts > 1:
            bs = min(batch_size, self.group_size)
            for ii in range(n_images):
                for start in range(0, n, bs):
                    chunk = dataset[start : start + bs]
                    out[start : start + len(chunk), ii] = self.groups_forward(
                        [s["images"][ii] for s in chunk],
                        [list(s["texts"]) for s in chunk], **kwargs
                    )
            return out
        if self.image_texts_forward is not None and n_texts > 1:
            for si, sample in enumerate(dataset):
                for ii in range(n_images):
                    out[si, ii] = self.image_texts_forward(
                        sample["images"][ii], list(sample["texts"]), **kwargs
                    )
            return out
        for start in range(0, n, batch_size):
            chunk = dataset[start : start + batch_size]
            for ii in range(n_images):
                images = [s["images"][ii] for s in chunk]
                for ti in range(n_texts):
                    texts = [s["texts"][ti] for s in chunk]
                    out[start : start + len(chunk), ii, ti] = self.pair_forward(
                        images, texts, **kwargs
                    )
        return out


def VQAScore(model, params, tokenize, group_size: int = 8, **kw) -> Score:
    """VQAScore factory over a JAX LLaVA model (t2v_metrics.VQAScore)."""
    from .vqa_score import VQAScorer

    scorer = VQAScorer(model, params, tokenize, **kw)
    return Score(scorer.forward, scorer.forward_image_texts,
                 scorer.forward_groups, group_size=group_size)


def T5VQAScore(model, params, tokenize, group_size: int = 8, **kw) -> Score:
    """VQAScore factory over a JAX CLIP-FlanT5 model — the reference's
    DEFAULT VQAScore backbone (t2v_metrics/vqascore.py:11 clip-flant5-xxl).
    The m x n broadcast routes through image-feature reuse: one vision-tower
    pass per image instead of per (image, text) pair."""
    from .vqa_score import T5VQAScorer

    scorer = T5VQAScorer(model, params, tokenize, **kw)
    return Score(scorer.forward, scorer.forward_image_texts,
                 scorer.forward_groups, group_size=group_size)


def InstructBlipVQAScore(model, params, qformer_tokenize, t5_tokenize,
                         **kw) -> Score:
    """VQAScore factory over an InstructBLIP-FlanT5 model
    (t2v_metrics instructblip_model.py). The m x n broadcast caches the
    EVA-g vision tower per image (the Q-Former/T5 condition on the text,
    so they run per pair)."""
    from .vqa_score import InstructBlipVQAScorer

    scorer = InstructBlipVQAScorer(
        model, params, qformer_tokenize, t5_tokenize, **kw
    )
    return Score(scorer.forward, scorer.forward_image_texts)


def CLIPScore(model, params, **kw) -> Score:
    """Cosine-similarity CLIPScore over a JAX CLIP model
    (t2v clipscore_models/clip_model.py:44-58)."""
    from .scorers import CLIPScorer

    scorer = CLIPScorer(model, params, **kw)

    def pair_forward(images, texts):
        # float32 for the host-side einsum (bf16 models return bf16 numpy,
        # which numpy einsum rejects)
        img = scorer.encode_images(images).astype(np.float32)
        txt = scorer.encode_texts(texts).astype(np.float32)
        return np.einsum("nd,nd->n", img, txt)

    return Score(pair_forward)


def ImageRewardScore(model, params, tokenize, image_size: int = 224,
                     max_length: int = 35, batch_size: int = 8) -> Score:
    """ImageReward ITMScore (t2v itmscore_models/image_reward_model.py:44-72):
    standardized BLIP reward-head score per (image, text) pair; tokenizer
    truncates/pads to 35 like the reference."""
    import jax
    import jax.numpy as jnp

    from ..image.preprocess import preprocess_batch

    @jax.jit
    def _scores(params, pixels, ids, mask):
        return model.apply({"params": params}, pixels, ids, mask)

    def pair_forward(images, texts):
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), batch_size):
            imgs = images[s : s + batch_size]
            txts = texts[s : s + batch_size]
            rows = [tokenize(t)[:max_length] for t in txts]
            ids = np.zeros((len(rows), max_length), np.int32)
            mask = np.zeros((len(rows), max_length), bool)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = True
            pixels = preprocess_batch(list(imgs), image_size, "clip")
            out[s : s + len(rows)] = np.asarray(_scores(
                params, jnp.asarray(pixels), jnp.asarray(ids),
                jnp.asarray(mask),
            ))
        return out

    return Score(pair_forward)


def ITMScore(model, params, tokenize, image_size: int = 224,
             max_length: int = 35, batch_size: int = 8) -> Score:
    """BLIP-2 ITM matching probability (t2v itmscore_models/
    blip2_itm_model.py: softmax(itm_logits)[:, 1])."""
    import jax
    import jax.numpy as jnp

    from ..image.preprocess import preprocess_batch

    @jax.jit
    def _logits(params, pixels, ids, mask):
        return model.apply(
            {"params": params}, pixels, ids, mask, method="itm_logits"
        )

    def pair_forward(images, texts):
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), batch_size):
            imgs = images[s : s + batch_size]
            txts = texts[s : s + batch_size]
            rows = [tokenize(t)[:max_length] for t in txts]
            ids = np.zeros((len(rows), max_length), np.int32)
            mask = np.zeros((len(rows), max_length), bool)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = True
            pixels = preprocess_batch(list(imgs), image_size, "clip")
            logits = np.asarray(_logits(
                params, jnp.asarray(pixels), jnp.asarray(ids),
                jnp.asarray(mask),
            ))
            e = np.exp(logits - logits.max(axis=-1, keepdims=True))
            out[s : s + len(rows)] = (e / e.sum(axis=-1, keepdims=True))[:, 1]
        return out

    return Score(pair_forward)
