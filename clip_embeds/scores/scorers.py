"""Batched scorers bridging models to the eval drivers.

The reference drivers run one PIL image + a couple of captions per forward
(eval_clip.py:50-65); here images and texts are accumulated and encoded in
fixed-size device batches (padded to avoid recompiles), which is where the
device throughput comes from. Scoring conventions per family (SURVEY.md §2a):

* CLIPScorer   — probs = softmax(100 * img @ txt.T) over options, row compare.
* PACLScorer   — raw 100 * cosine, diagonal compare (eval_pacl.py:52-57);
                 uniform pooling makes the visual embed text-independent, so
                 images are encoded once; weighted/rope-after variants score
                 per (image, text) pair.
* SPARCScorer  — global (mean-pooled) or local (grouped) scoring
                 (pacl.py:438-451).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..image.preprocess import ImageLike, preprocess_batch
from ..models.clip import l2_normalize
from ..models.heads import language_mask_from_ids
from ..text.tokenizer import get_tokenizer


def _batched(encode_fn: Callable, items: np.ndarray, batch_size: int) -> np.ndarray:
    """Run a jitted encoder over items in padded fixed-size batches."""
    n = len(items)
    outs = []
    for start in range(0, n, batch_size):
        chunk = items[start : start + batch_size]
        pad = batch_size - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)])
        out = np.asarray(encode_fn(chunk))
        outs.append(out[: len(out) - pad] if pad else out)
    return np.concatenate(outs, axis=0)


class CLIPScorer:
    """Dual-tower cosine scorer over a CLIP model."""

    def __init__(
        self,
        model,
        params,
        batch_size: int = 64,
        preprocess_variant: str = "clip",
        dtype=jnp.float32,
    ):
        self.model = model
        # commit params to device once — host arrays would re-upload
        # on every jit call
        self.params = jax.device_put(params)
        self.batch_size = batch_size
        self.image_size = model.cfg.vision.image_size
        self.preprocess_variant = preprocess_variant
        self.tokenizer = get_tokenizer(model.cfg.text.context_length)

        # params flow as jit ARGUMENTS (closing over them would inline
        # gigabytes of weights as HLO constants)
        @jax.jit
        def _encode_images(params, images):
            return model.apply(
                {"params": params}, images, normalize=True,
                method="encode_image",
            )

        @jax.jit
        def _encode_texts(params, texts):
            return model.apply(
                {"params": params}, texts, normalize=True,
                method="encode_text",
            )

        self._encode_images = lambda x: _encode_images(self.params, x)
        self._encode_texts = lambda x: _encode_texts(self.params, x)

    def encode_images(self, images: Sequence[ImageLike]) -> np.ndarray:
        pixels = preprocess_batch(images, self.image_size, self.preprocess_variant)
        return _batched(self._encode_images, pixels, self.batch_size)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        tokens = self.tokenizer(list(texts))
        return _batched(self._encode_texts, tokens, self.batch_size)

    # -- driver interfaces -------------------------------------------------

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        """Per-sample softmax(100*sim) option scores (eval_clip.py:58-65)."""
        images = [s[0] for s in samples]
        img_feats = self.encode_images(images)
        all_texts: List[str] = []
        offsets = [0]
        for _, options in samples:
            all_texts.extend(options)
            offsets.append(offsets[-1] + len(options))
        txt_feats = self.encode_texts(all_texts)

        out = []
        for i, (_, options) in enumerate(samples):
            tf = txt_feats[offsets[i] : offsets[i + 1]]
            logits = 100.0 * img_feats[i] @ tf.T
            probs = np.exp(logits - logits.max())
            out.append(probs / probs.sum())
        return out

    def pair_score(self, images: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        """t2i softmax over images per text (MMVP, eval_clip.py:296-307)."""
        img = self.encode_images(images)
        txt = self.encode_texts(texts)
        logits = 100.0 * txt @ img.T
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def score_matrix(self, images: Sequence[ImageLike], texts: Sequence[str]) -> np.ndarray:
        """Plain cosine m x n matrix (t2v_metrics CLIPScore semantics)."""
        return self.encode_images(images) @ self.encode_texts(texts).T


class PACLScorer:
    """Scorer over a frozen CLIP tower + PACL head."""

    def __init__(
        self,
        clip_model,
        clip_params,
        head_model,
        head_params,
        batch_size: int = 32,
        preprocess_variant: str = "pacl",
        text_encoder: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    ):
        self.clip_model = clip_model
        self.clip_params = jax.device_put(clip_params)
        self.head = head_model
        self.head_params = jax.device_put(head_params)
        self.batch_size = batch_size
        self.image_size = clip_model.cfg.vision.image_size
        self.preprocess_variant = preprocess_variant
        self.tokenizer = get_tokenizer(clip_model.cfg.text.context_length)
        self.text_encoder = text_encoder  # e.g. precomputed LLM2Vec embeds
        self.per_pair = head_model.rope == "after" or head_model.pooling == "weighted"

        @jax.jit
        def _patches(params, images):
            _, tokens = clip_model.apply(
                {"params": params}, images, output_tokens=True,
                method="encode_image",
            )
            return tokens

        @jax.jit
        def _text_cls(params, texts):
            return clip_model.apply(
                {"params": params}, texts, method="encode_text"
            )

        @jax.jit
        def _head(params, patches, text_emb):
            return head_model.apply({"params": params}, patches, text_emb)

        self._patches = lambda x: _patches(self.clip_params, x)
        self._text_cls = lambda x: _text_cls(self.clip_params, x)
        self._head = lambda a, b: _head(self.head_params, a, b)

    def _image_patches(self, images: Sequence[ImageLike]) -> np.ndarray:
        pixels = preprocess_batch(images, self.image_size, self.preprocess_variant)
        return _batched(self._patches, pixels, self.batch_size)

    def _text_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        if self.text_encoder is not None:
            return np.asarray(self.text_encoder(texts))
        tokens = self.tokenizer(list(texts))
        return _batched(self._text_cls, tokens, self.batch_size)

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        """Diagonal-compare scores: s[j] = 100 * cos(vis_j, txt_j) where the
        image is paired row-wise with each option (eval_pacl.py:52-57)."""
        patches = self._image_patches([s[0] for s in samples])
        out = []
        for i, (_, options) in enumerate(samples):
            t_emb = self._text_embeddings(options)
            tiled = np.repeat(patches[i : i + 1], len(options), axis=0)
            v, t = self._head(jnp.asarray(tiled), jnp.asarray(t_emb))
            out.append(np.asarray(100.0 * jnp.einsum("nd,nd->n", v, t)))
        return out

    def pair_score(self, images: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        patches = self._image_patches(images)
        t_emb = self._text_embeddings(texts)
        n_img, n_txt = len(images), len(texts)
        # pair every (text, image): tile patches per text
        v_list = []
        for j in range(n_txt):
            tiled_t = np.repeat(t_emb[j : j + 1], n_img, axis=0)
            v, t = self._head(jnp.asarray(patches), jnp.asarray(tiled_t))
            v_list.append(np.asarray(jnp.einsum("nd,nd->n", v, t)))
        logits = 100.0 * np.stack(v_list)  # [n_txt, n_img]
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class SPARCScorer:
    """SPARC scoring (pacl.py:438-451): global or local variant."""

    def __init__(
        self,
        clip_model,
        clip_params,
        head_model,
        head_params,
        batch_size: int = 32,
        local: bool = False,
        sigma: Optional[float] = None,
        preprocess_variant: str = "pacl",
    ):
        from ..losses.sparc import sparc_group_patches

        self.clip_model = clip_model
        self.clip_params = jax.device_put(clip_params)
        self.head = head_model
        self.head_params = jax.device_put(head_params)
        self.batch_size = batch_size
        self.local = local
        self.image_size = clip_model.cfg.vision.image_size
        self.preprocess_variant = preprocess_variant
        self.tokenizer = get_tokenizer(clip_model.cfg.text.context_length)
        # the reference sparc constructor defaults sigma to 1/625 regardless
        # of the tower's actual patch count (pacl.py:381; eval_sparc.py:368
        # never overrides it) — match that for eval parity
        self.sigma = sigma if sigma is not None else 1.0 / 625

        @jax.jit
        def _score(clip_params, head_params, images, texts):
            _, patches = clip_model.apply(
                {"params": clip_params}, images, output_tokens=True,
                method="encode_image",
            )
            _, text_tokens = clip_model.apply(
                {"params": clip_params}, texts, output_tokens=True,
                method="encode_text",
            )
            v, t = head_model.apply(
                {"params": head_params}, patches, text_tokens
            )
            # sparc.forward normalizes token/grouped embeddings PER TOKEN
            # before scoring means them (pacl.py:476-478 -> scoring 443-451):
            # normalize(mean(normalize(t))), not normalize(mean(t)). The raw
            # v feeds both the grouping similarity and the global image mean.
            global_txt = l2_normalize(l2_normalize(t).mean(axis=1))
            if self.local:
                grouped = sparc_group_patches(v, t, self.sigma)
                img = l2_normalize(l2_normalize(grouped).mean(axis=1))
            else:
                img = l2_normalize(v.mean(axis=1))
            return img @ global_txt.T

        self._score = lambda a, b: _score(
            self.clip_params, self.head_params, a, b
        )

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        out = []
        for image, options in samples:
            pixels = preprocess_batch(
                [image] * len(options), self.image_size, self.preprocess_variant
            )
            tokens = self.tokenizer(list(options))
            sim = np.asarray(self._score(jnp.asarray(pixels), jnp.asarray(tokens)))
            out.append(100.0 * np.diag(sim))
        return out

    def pair_score(self, images: Sequence[str], texts: Sequence[str]) -> np.ndarray:
        n_img, n_txt = len(images), len(texts)
        rows = []
        for j in range(n_txt):
            pixels = preprocess_batch(
                list(images), self.image_size, self.preprocess_variant
            )
            tokens = self.tokenizer([texts[j]] * n_img)
            sim = np.asarray(self._score(jnp.asarray(pixels), jnp.asarray(tokens)))
            rows.append(100.0 * np.diag(sim))
        logits = np.stack(rows)
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


class SiglipScorer:
    """SigLIP dual-encoder scorer (sigmoid-loss scoring semantics).

    Reference: VLM2Vec/evaluation/eval_siglip.py runs
    google/siglip-so400m-patch14-384 through the MMEB cosine protocol; the
    SigLIP pairing score itself is sigmoid(logit_scale*cos + logit_bias)
    (models/siglip.py). ``tokenize`` is any texts -> int [B, 64] ids callable;
    text/tokenizer.py SigLipTokenizer (pure-Python sentencepiece unigram over
    a local .model file, no native dependency) is the drop-in native choice.
    """

    def __init__(
        self,
        model,
        params,
        tokenize,
        batch_size: int = 64,
        dtype=jnp.float32,
    ):
        self.model = model
        # commit params to device once — host arrays would re-upload
        # on every jit call
        self.params = jax.device_put(params)
        self.tokenize = tokenize
        self.batch_size = batch_size
        self.image_size = model.cfg.vision.image_size

        @jax.jit
        def _encode_images(params, images):
            return model.apply(
                {"params": params}, images, method="encode_image"
            )

        @jax.jit
        def _encode_texts(params, ids):
            return model.apply(
                {"params": params}, ids, method="encode_text"
            )

        self._encode_images = lambda x: _encode_images(self.params, x)
        self._encode_texts = lambda x: _encode_texts(self.params, x)
        self._scale = float(np.exp(np.asarray(params["logit_scale"])))
        self._bias = float(np.asarray(params["logit_bias"]))

    def encode_images(self, images: Sequence[ImageLike]) -> np.ndarray:
        pixels = preprocess_batch(images, self.image_size, "siglip")
        return _batched(self._encode_images, pixels, self.batch_size)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        ids = np.asarray(self.tokenize(list(texts)))
        return _batched(self._encode_texts, ids, self.batch_size)

    def sigmoid_scores(
        self, images: Sequence[ImageLike], texts: Sequence[str]
    ) -> np.ndarray:
        """m x n pairing probabilities sigmoid(scale*cos + bias)."""
        sims = self.encode_images(images) @ self.encode_texts(texts).T
        z = self._scale * sims + self._bias
        return 1.0 / (1.0 + np.exp(-z))

    def score_batch(
        self, samples: Sequence[Tuple[ImageLike, List[str]]]
    ) -> List[np.ndarray]:
        """Per-sample softmax over option cosines (driver protocol)."""
        images = [s[0] for s in samples]
        img_feats = self.encode_images(images)
        all_texts: List[str] = []
        offsets = [0]
        for _, options in samples:
            all_texts.extend(options)
            offsets.append(offsets[-1] + len(options))
        txt_feats = self.encode_texts(all_texts)
        out = []
        for i in range(len(samples)):
            tf = txt_feats[offsets[i]:offsets[i + 1]]
            logits = self._scale * img_feats[i] @ tf.T + self._bias
            e = np.exp(logits - logits.max())
            out.append(e / e.sum())
        return out

    def pair_score(
        self, images: Sequence[str], texts: Sequence[str]
    ) -> np.ndarray:
        """t2i softmax over images per text (MMVP-VLM protocol)."""
        img = self.encode_images(images)
        txt = self.encode_texts(texts)
        logits = self._scale * txt @ img.T + self._bias
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
