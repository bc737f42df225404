"""Embedding-based scorer for VLM2Vec-style models (LLaVA as bi-encoder).

Reference: VLM2Vec/eval_llava15.py — queries are (image + question template)
last-token embeddings, targets are per-option text embeddings; similarity is
qry @ tgt.T (model.py:247-248 compute_similarity), softmaxed over options for
MMVP-style t2i picks (eval_llava15.py:397-424).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..image.preprocess import ImageLike, preprocess_batch
from ..models.llava import Llava
from ..scores.vqa_score import tokenizer_image_token

DEFAULT_QUERY_TEMPLATE = (
    "<image>\nRepresent the given image with the following question: {}"
)

TokenizeFn = Callable[[str], List[int]]


class EmbeddingScorer:
    def __init__(
        self,
        model: Llava,
        params,
        tokenize: TokenizeFn,
        bos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        batch_size: int = 8,
        max_len: int = 1024,
        query_template: str = DEFAULT_QUERY_TEMPLATE,
        lora=None,
    ):
        self.model = model
        # commit params to device once — host arrays would re-upload
        # on every jit call
        variables = {"params": params}
        if lora is not None:
            # unmaterialized adapters (flat tree from cli/train_vlm2vec
            # --quant_base): served through the 'lora' collection beside a
            # frozen fp/int8 base instead of merge_lora (models/quant.py
            # _lora_delta)
            from ..models.lora import normalize_lora, to_collection

            if not getattr(model, "lora_rank", 0):
                raise ValueError(
                    "unmaterialized adapters need a model built with "
                    "lora_rank > 0")
            variables["lora"] = to_collection(normalize_lora(lora))
        self.variables = jax.device_put(variables)
        self.tokenize = tokenize
        self.bos_token_id = bos_token_id
        self.pad_token_id = pad_token_id
        self.batch_size = batch_size
        self.max_len = max_len
        self.query_template = query_template
        self.image_size = model.cfg.vision.image_size

        @jax.jit
        def _embed_query(variables, ids, pixels, mask):
            return model.apply(
                variables, ids, pixels, mask,
                method="embed_last_token",
            )

        @jax.jit
        def _embed_text(variables, ids, mask):
            return model.apply(
                variables, ids, None, mask,
                method="embed_last_token",
            )

        self._embed_query = _embed_query
        self._embed_text = _embed_text

    def _pad(self, rows: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        longest = ((max(len(r) for r in rows) + 63) // 64) * 64
        ids = np.full((len(rows), longest), self.pad_token_id, np.int32)
        mask = np.zeros((len(rows), longest), bool)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = True
        return ids, mask

    def embed_queries(
        self, images: Sequence[ImageLike], questions: Sequence[str]
    ) -> np.ndarray:
        rows = [
            tokenizer_image_token(
                self.query_template.format(q), self.tokenize, self.bos_token_id
            )[: self.max_len]
            for q in questions
        ]
        return self._run_image_rows(rows, images)

    def embed_image_texts(
        self, images: Sequence[ImageLike], texts: Sequence[str]
    ) -> np.ndarray:
        """Image+text embeddings for raw texts carrying an ``<image>``
        placeholder (prepended when absent) — the target-side encoding for
        t2i-retrieval MMEB subsets (VLM2Vec/eval.py encodes targets with
        their images; src/dataset.py:197-215 pairs keep img_path)."""
        texts = [t if "<image>" in t else "<image>\n" + t for t in texts]
        rows = [
            tokenizer_image_token(t, self.tokenize, self.bos_token_id)
            [: self.max_len]
            for t in texts
        ]
        return self._run_image_rows(rows, images)

    def _run_image_rows(
        self, rows: List[List[int]], images: Sequence[ImageLike]
    ) -> np.ndarray:
        out = []
        for s in range(0, len(rows), self.batch_size):
            ids, mask = self._pad(rows[s : s + self.batch_size])
            pixels = preprocess_batch(
                list(images[s : s + self.batch_size]), self.image_size, "llava"
            )
            out.append(np.asarray(self._embed_query(
                self.variables, jnp.asarray(ids), jnp.asarray(pixels),
                jnp.asarray(mask),
            )))
        return np.concatenate(out)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        rows = [self.tokenize(t)[: self.max_len] for t in texts]
        out = []
        for s in range(0, len(rows), self.batch_size):
            ids, mask = self._pad(rows[s : s + self.batch_size])
            out.append(np.asarray(self._embed_text(
                self.variables, jnp.asarray(ids), jnp.asarray(mask)
            )))
        return np.concatenate(out)

    # -- driver interfaces -------------------------------------------------

    def score_batch(
        self,
        samples: Sequence[Tuple[ImageLike, List[str]]],
        question: str = "",
    ) -> List[np.ndarray]:
        images = [s[0] for s in samples]
        qry = self.embed_queries(images, [question] * len(images))
        out = []
        for i, (_, options) in enumerate(samples):
            tgt = self.embed_texts(options)
            out.append(qry[i] @ tgt.T)
        return out

    def pair_score(
        self,
        images: Sequence[str],
        texts: Sequence[str],
        questions: Optional[Sequence[str]] = None,
    ) -> np.ndarray:
        """t2i softmax over images per text (eval_llava15.py MMVP mode)."""
        questions = questions or [""] * len(images)
        qry = self.embed_queries(images, questions)
        tgt = self.embed_texts(texts)
        logits = 100.0 * tgt @ qry.T  # [texts, images]
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)
