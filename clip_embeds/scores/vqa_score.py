"""VQAScore: P(answer="Yes" | image, question) = exp(-mean CE).

Reference: t2v_metrics/t2v_metrics/models/vqascore_models/llava_model.py:
question/answer templates (:14-15), the 'chat' conversation format with
SYSTEM_MSG (:17-58), <image>-splitting tokenization
(mm_utils.py:24-44 tokenizer_image_token), question-prefix label masking with
the trailing-whitespace correction (:314-319), and per-sample (-CE).exp()
(:359-370).

The tokenizer is pluggable: any callable text -> List[int] (HF Llama tokenizer
via ``hf_tokenizer_adapter`` for real checkpoints, or a toy tokenizer in
tests).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..image.preprocess import ImageLike, preprocess_batch
from ..models.llava import IGNORE_INDEX, IMAGE_TOKEN_INDEX, Llava

SYSTEM_MSG = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)
DEFAULT_IMAGE_TOKEN = "<image>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
DEFAULT_QUESTION_TEMPLATE = 'Does this figure show "{}"? Please answer yes or no.'
DEFAULT_ANSWER_TEMPLATE = "Yes"

# MPT-style single-turn prompts (reference conversation.py:65-73 get_prompt
# with conv_phi3_instruct :373-380 / conv_llama3 :383-391):
#     system + sep + role0 + question + sep + role1
PHI3_SYSTEM = "<|system|>\nYou are a helpful AI assistant."
LLAMA3_SYSTEM = (
    "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
    + SYSTEM_MSG
)

TokenizeFn = Callable[[str], List[int]]


def _exp_neg_mean_ce(shift_logits, shift_labels):
    """exp(-mean CE over non-IGNORE labels) per row
    (llava_model.py:359-370)."""
    valid = shift_labels != IGNORE_INDEX
    safe = jnp.where(valid, shift_labels, 0)
    logz = jax.nn.logsumexp(shift_logits, axis=-1)
    picked = jnp.take_along_axis(shift_logits, safe[..., None], axis=-1)[..., 0]
    ce = (logz - picked) * valid
    mean_ce = ce.sum(axis=1) / jnp.maximum(valid.sum(axis=1), 1)
    return jnp.exp(-mean_ce)


def format_question(question: str, style: str = "chat") -> str:
    """llava_model.py:17-42 conversation formats incl. the paper-added
    phi3_instruct / llama3 styles (llava-phi-3, llava-llama-3)."""
    if style == "plain":
        return DEFAULT_IMAGE_TOKEN + question
    if style == "chat":
        return (
            SYSTEM_MSG + " USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question
            + " ASSISTANT: "
        )
    if style in ("phi3_instruct", "llama3"):
        if IMAGE_PLACEHOLDER in question:
            qs = question.replace(IMAGE_PLACEHOLDER, DEFAULT_IMAGE_TOKEN)
        else:
            qs = DEFAULT_IMAGE_TOKEN + "\n" + question
        if style == "phi3_instruct":
            return (
                PHI3_SYSTEM + "<|end|>" + "\n<|user|>\n" + qs + "<|end|>"
                + "\n<|assistant|>\n"
            )
        return (
            LLAMA3_SYSTEM + "<|eot_id|>"
            + "<|start_header_id|>user<|end_header_id|>\n\n" + qs
            + "<|eot_id|>"
            + "<|start_header_id|>assistant<|end_header_id|>\n\n"
        )
    raise NotImplementedError(style)


def format_answer(answer: str, style: str = "chat") -> str:
    """llava_model.py:44-58: answer + per-style end-of-turn token."""
    if style == "plain":
        return answer + "\n"
    if style == "chat":
        return answer + "</s>"
    if style == "phi3_instruct":
        return answer + "<|end|>"
    if style == "llama3":
        return answer + "<|eot_id|>"
    raise NotImplementedError(style)


def tokenizer_image_token(
    prompt: str,
    tokenize: TokenizeFn,
    bos_token_id: Optional[int] = None,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """Split on <image>, tokenize chunks, splice the sentinel id between them
    (mm_utils.py:24-44 semantics including the BOS offset handling)."""
    chunks = [tokenize(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and bos_token_id is not None and chunks[0][0] == bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    joined: List[List[int]] = []
    for i, chunk in enumerate(chunks):
        joined.append(chunk)
        if i < len(chunks) - 1:
            joined.append(sep)
    for segment in joined:
        ids.extend(segment[offset:])
    return ids


def hf_tokenizer_adapter(hf_tokenizer) -> tuple:
    """(tokenize_fn, bos_token_id, pad_token_id) from an HF tokenizer."""
    return (
        lambda text: hf_tokenizer(text).input_ids,
        hf_tokenizer.bos_token_id,
        hf_tokenizer.pad_token_id or 0,
    )


class VQAScorer:
    """Batched VQAScore over a JAX LLaVA model."""

    def __init__(
        self,
        model: Llava,
        params,
        tokenize: TokenizeFn,
        bos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        conversation_style: str = "chat",
        context_len: int = 2048,
        batch_size: int = 8,
        pad_to_multiple: int = 64,
        suffix_pad_to_multiple: int = 16,
    ):
        self.model = model
        # commit params to device once — host arrays would re-upload
        # on every jit call
        self.params = jax.device_put(params)
        self.tokenize = tokenize
        self.bos_token_id = bos_token_id
        self.pad_token_id = pad_token_id
        self.style = conversation_style
        self.context_len = context_len
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.suffix_pad_to_multiple = suffix_pad_to_multiple
        self.image_size = model.cfg.vision.image_size

        import functools

        @functools.partial(jax.jit, static_argnums=())
        def _scores(params, input_ids, pixels, attn_mask, labels):
            logits = model.apply(
                {"params": params}, input_ids, pixels, attn_mask
            )
            n_image = model.cfg.n_image_tokens
            from ..models.llava import expand_like_tokens

            full_labels = expand_like_tokens(
                labels, input_ids, n_image, IGNORE_INDEX
            )
            shift_logits = logits[:, :-1].astype(jnp.float32)
            shift_labels = full_labels[:, 1:]
            return _exp_neg_mean_ce(shift_logits, shift_labels)

        self._scores = _scores

        from ..models.llava import extract_prefix_kv

        @jax.jit
        def _prefill(params, prefix_ids, pixels, prefix_valid):
            mask, mut = model.apply(
                {"params": params}, prefix_ids, pixels, prefix_valid,
                method="prefill", mutable=["kv"],
            )
            kv = extract_prefix_kv(mut["kv"], model.cfg.llama.num_layers)
            return kv, mask

        self._prefill = _prefill

        @jax.jit
        def _suffix_scores(params, suffix_ids, suffix_mask, labels, kv,
                           pmask, prefix_len):
            logits = model.apply(
                {"params": params}, suffix_ids, kv, pmask, suffix_mask,
                prefix_len, method="suffix_logits",
            )
            shift_logits = logits[:, :-1].astype(jnp.float32)
            shift_labels = labels[:, 1:]
            return _exp_neg_mean_ce(shift_logits, shift_labels)

        self._suffix_scores = _suffix_scores

    def _prepare(self, image: ImageLike, text: str, q_tpl: str, a_tpl: str):
        question = format_question(q_tpl.format(text), self.style)
        answer = format_answer(a_tpl.format(text), self.style)
        ids = tokenizer_image_token(
            question + answer, self.tokenize, self.bos_token_id
        )
        q_len = len(
            tokenizer_image_token(question, self.tokenize, self.bos_token_id)
        )
        if question.endswith(" "):
            q_len -= 1  # llava_model.py:317-319 whitespace correction
        labels = [IGNORE_INDEX] * q_len + ids[q_len:]
        return ids[: self.context_len], labels[: self.context_len]

    def forward(
        self,
        images: Sequence[ImageLike],
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """Scores for n (image, text) pairs -> [n] array."""
        assert len(images) == len(texts)
        prepared = [
            self._prepare(img, txt, question_template, answer_template)
            for img, txt in zip(images, texts)
        ]
        out = np.zeros((len(prepared),), np.float32)
        for start in range(0, len(prepared), self.batch_size):
            chunk = prepared[start : start + self.batch_size]
            imgs = images[start : start + self.batch_size]
            out[start : start + len(chunk)] = self._forward_chunk(chunk, imgs)
        return out

    def forward_image_texts(
        self,
        image: ImageLike,
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """Score ONE image against n texts with image-KV-prefix reuse.

        The reference broadcasts m x n by repeating the image per text and
        re-running the full 7B forward per pair (score.py:43-57) — but the
        image block (576 tokens) plus the common question prefix is
        text-independent. Here the shared prefix prefills the trunk once
        (``Llava.prefill``), its per-layer KV is cached, and the n candidate
        suffixes (~10-30 tokens each) run batched against the broadcast
        prefix KV (``Llava.suffix_logits``). Exactness vs the pair path is
        tested (tests/test_vqa_prefix.py); ideal speedup ~n x on the prefix
        FLOPs.
        """
        texts = list(texts)
        n = len(texts)
        prepared = [
            self._prepare(image, t, question_template, answer_template)
            for t in texts
        ]
        rows = [ids for ids, _ in prepared]
        # longest common token prefix across candidates
        lcp = len(rows[0])
        for r in rows[1:]:
            m = min(lcp, len(r))
            i = 0
            while i < m and r[i] == rows[0][i]:
                i += 1
            lcp = i
        first_label = min(
            next(i for i, l in enumerate(lab) if l != IGNORE_INDEX)
            for _, lab in prepared
        )
        # the first suffix token's predictor must live in the suffix
        prefix_len = min(lcp, first_label - 1)
        sentinel = rows[0].index(IMAGE_TOKEN_INDEX) \
            if IMAGE_TOKEN_INDEX in rows[0] else -1
        if n < 2 or prefix_len < 8 or not (0 <= sentinel < prefix_len):
            return self.forward([image] * n, texts, question_template,
                                answer_template)

        mpre = self.pad_to_multiple
        lp_pad = ((prefix_len + mpre - 1) // mpre) * mpre
        prefix_ids = np.full((1, lp_pad), self.pad_token_id, np.int32)
        prefix_ids[0, :prefix_len] = rows[0][:prefix_len]
        # padded slots must not alias the sentinel
        prefix_valid = np.zeros((1, lp_pad), bool)
        prefix_valid[0, :prefix_len] = True
        pixels = preprocess_batch([image], self.image_size, "llava")
        kv, pmask = self._prefill(
            self.params, jnp.asarray(prefix_ids), jnp.asarray(pixels),
            jnp.asarray(prefix_valid),
        )
        n_image = self.model.cfg.n_image_tokens
        real_f = jnp.asarray(prefix_len - 1 + n_image, jnp.int32)

        ms = self.suffix_pad_to_multiple
        out = np.zeros((n,), np.float32)
        for s in range(0, n, self.batch_size):
            chunk = prepared[s : s + self.batch_size]
            b = len(chunk)
            ls = max(len(ids) - prefix_len for ids, _ in chunk)
            ls = ((ls + ms - 1) // ms) * ms
            suffix_ids = np.full((b, ls), self.pad_token_id, np.int32)
            labels = np.full((b, ls), IGNORE_INDEX, np.int32)
            suffix_mask = np.zeros((b, ls), bool)
            for i, (ids, lab) in enumerate(chunk):
                tail = ids[prefix_len:]
                suffix_ids[i, : len(tail)] = tail
                labels[i, : len(tail)] = lab[prefix_len:]
                suffix_mask[i, : len(tail)] = True
            out[s : s + b] = np.asarray(self._suffix_scores(
                self.params, jnp.asarray(suffix_ids),
                jnp.asarray(suffix_mask), jnp.asarray(labels), kv, pmask,
                real_f,
            ))
        return out

    def forward_groups(
        self,
        images: Sequence[ImageLike],            # k images
        texts_per_image: Sequence[Sequence[str]],  # k lists of n texts each
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """[k, n] scores with TWO dispatches total: one batched prefill of
        the k distinct images (per-row sentinels/prefix lengths), then one
        suffix pass where each row holds its n candidate suffixes
        CONCATENATED, attending block-diagonally over the row's prefix KV
        (Llava.suffix_logits suffix_block — no KV replication). The
        per-image path pays 2 dispatches PER image; this pays 2 per k-group,
        which is what batch_forward-style dataset evals want on
        high-latency links."""
        k = len(images)
        assert k == len(texts_per_image)
        n = len(texts_per_image[0])
        assert all(len(t) == n for t in texts_per_image), (
            "forward_groups needs a uniform text count per image")

        groups = []
        for img, texts in zip(images, texts_per_image):
            prepared = [
                self._prepare(img, t, question_template, answer_template)
                for t in texts
            ]
            rows = [ids for ids, _ in prepared]
            lcp = len(rows[0])
            for r in rows[1:]:
                m = min(lcp, len(r))
                i = 0
                while i < m and r[i] == rows[0][i]:
                    i += 1
                lcp = i
            first_label = min(
                next(i for i, l in enumerate(lab) if l != IGNORE_INDEX)
                for _, lab in prepared
            )
            prefix_len = min(lcp, first_label - 1)
            sentinel = rows[0].index(IMAGE_TOKEN_INDEX) \
                if IMAGE_TOKEN_INDEX in rows[0] else -1
            if n < 2 or prefix_len < 8 or not (0 <= sentinel < prefix_len):
                groups.append(None)  # fall back per-image below
            else:
                groups.append((prepared, prefix_len))

        out = np.zeros((k, n), np.float32)
        live = [i for i, g in enumerate(groups) if g is not None]
        for i, g in enumerate(groups):
            if g is None:
                out[i] = self.forward_image_texts(
                    images[i], list(texts_per_image[i]),
                    question_template, answer_template)
        if not live:
            return out

        mpre = self.pad_to_multiple
        lp_pad = max(g[1] for i, g in enumerate(groups) if g is not None)
        lp_pad = ((lp_pad + mpre - 1) // mpre) * mpre
        ms = self.suffix_pad_to_multiple
        ls = max(
            len(ids) - groups[i][1]
            for i in live for ids, _ in groups[i][0]
        )
        ls = ((ls + ms - 1) // ms) * ms

        kb = len(live)
        prefix_ids = np.full((kb, lp_pad), self.pad_token_id, np.int32)
        prefix_valid = np.zeros((kb, lp_pad), bool)
        suffix_ids = np.full((kb, n * ls), self.pad_token_id, np.int32)
        suffix_mask = np.zeros((kb, n * ls), bool)
        labels = np.full((kb, n * ls), IGNORE_INDEX, np.int32)
        real_f = np.zeros((kb,), np.int32)
        n_image = self.model.cfg.n_image_tokens
        for row, gi in enumerate(live):
            prepared, plen = groups[gi]
            prefix_ids[row, :plen] = prepared[0][0][:plen]
            prefix_valid[row, :plen] = True
            real_f[row] = plen - 1 + n_image
            for t, (ids, lab) in enumerate(prepared):
                tail = ids[plen:]
                suffix_ids[row, t * ls : t * ls + len(tail)] = tail
                labels[row, t * ls : t * ls + len(tail)] = lab[plen:]
                suffix_mask[row, t * ls : t * ls + len(tail)] = True

        pixels = preprocess_batch(
            [images[i] for i in live], self.image_size, "llava")
        scores = np.asarray(self._group_scores(ls)(
            self.params, jnp.asarray(prefix_ids), jnp.asarray(pixels),
            jnp.asarray(prefix_valid), jnp.asarray(suffix_ids),
            jnp.asarray(suffix_mask), jnp.asarray(labels),
            jnp.asarray(real_f),
        ))
        for row, gi in enumerate(live):
            out[gi] = scores[row]
        return out

    def _group_scores(self, ls: int):
        """Jitted (prefill + block-causal concatenated suffix) composite for
        a given per-text suffix width (one compile per distinct width)."""
        cache = self.__dict__.setdefault("_group_scores_cache", {})
        if ls in cache:
            return cache[ls]
        model = self.model
        from ..models.llava import extract_prefix_kv

        import jax as _jax

        @_jax.jit
        def fn(params, prefix_ids, pixels, prefix_valid, suffix_ids,
               suffix_mask, labels, real_f):
            pmask, mut = model.apply(
                {"params": params}, prefix_ids, pixels, prefix_valid,
                method="prefill", mutable=["kv"],
            )
            kv = extract_prefix_kv(mut["kv"], model.cfg.llama.num_layers)
            logits = model.apply(
                {"params": params}, suffix_ids, kv, pmask, suffix_mask,
                real_f, method="suffix_logits", suffix_block=ls,
            )
            kb = suffix_ids.shape[0]
            n = suffix_ids.shape[1] // ls
            vocab = logits.shape[-1]
            blocks = logits.reshape(kb * n, ls, vocab)
            lab = labels.reshape(kb * n, ls)
            scores = _exp_neg_mean_ce(
                blocks[:, :-1].astype(jnp.float32), lab[:, 1:])
            return scores.reshape(kb, n)

        cache[ls] = fn
        return fn

    def _forward_chunk(self, prepared, images) -> np.ndarray:
        n = len(prepared)
        max_len = max(len(ids) for ids, _ in prepared)
        m = self.pad_to_multiple
        max_len = ((max_len + m - 1) // m) * m
        input_ids = np.full((n, max_len), self.pad_token_id, np.int32)
        labels = np.full((n, max_len), IGNORE_INDEX, np.int32)
        mask = np.zeros((n, max_len), bool)
        for i, (ids, lab) in enumerate(prepared):
            input_ids[i, : len(ids)] = ids
            labels[i, : len(lab)] = lab
            mask[i, : len(ids)] = True
        pixels = preprocess_batch(list(images), self.image_size, "llava")
        return np.asarray(
            self._scores(
                self.params,
                jnp.asarray(input_ids),
                jnp.asarray(pixels),
                jnp.asarray(mask),
                jnp.asarray(labels),
            )
        )


# -- InstructBLIP (Q-Former + FlanT5) ---------------------------------------

INSTRUCTBLIP_QUESTION_TEMPLATE = (
    'Question: Does this figure show "{}"? Please answer yes or no.'
)
INSTRUCTBLIP_ANSWER_TEMPLATE = "yes"  # instructblip uses lowercase


class InstructBlipVQAScorer:
    """VQAScore over an InstructBLIP-FlanT5 model
    (instructblip_model.py:63-139): the question text goes BOTH to the
    Q-Former (BERT tokenizer) as the instruction and to the T5 encoder; the
    decoder teacher-forces the answer; score = exp(-mean CE)."""

    def __init__(
        self,
        model,  # models.instructblip.InstructBlipT5
        params,
        qformer_tokenize: TokenizeFn,
        t5_tokenize: TokenizeFn,
        qformer_pad_id: int = 0,
        t5_pad_id: int = 0,
        max_txt_len: int = 128,        # lavis blip2_t5_instruct default
        max_output_txt_len: int = 256,
        batch_size: int = 8,
        pad_to_multiple: int = 32,
    ):
        self.model = model
        # commit params to device once — host arrays would re-upload
        # on every jit call
        self.params = jax.device_put(params)
        self.qformer_tokenize = qformer_tokenize
        self.t5_tokenize = t5_tokenize
        self.qformer_pad_id = qformer_pad_id
        self.t5_pad_id = t5_pad_id
        self.max_txt_len = max_txt_len
        self.max_output_txt_len = max_output_txt_len
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.image_size = model.cfg.vision.image_size

        @jax.jit
        def _scores(params, pixels, q_ids, q_mask, t5_ids, t5_mask, labels,
                    dec_mask):
            logits = model.apply(
                {"params": params}, pixels, q_ids, t5_ids, labels,
                q_mask, t5_mask, dec_mask,
            ).astype(jnp.float32)
            valid = labels != IGNORE_INDEX
            safe = jnp.where(valid, labels, 0)
            logz = jax.nn.logsumexp(logits, axis=-1)
            picked = jnp.take_along_axis(logits, safe[..., None], axis=-1)[..., 0]
            ce = (logz - picked) * valid
            mean_ce = ce.sum(axis=1) / jnp.maximum(valid.sum(axis=1), 1)
            return jnp.exp(-mean_ce)

        @jax.jit
        def _encode_vision(params, pixels):
            return model.apply(
                {"params": params}, pixels, method="encode_vision"
            )

        @jax.jit
        def _scores_vision(params, embeds, img_idx, q_ids, q_mask, t5_ids,
                           t5_mask, labels, dec_mask):
            logits = model.apply(
                {"params": params}, embeds[img_idx], q_ids, t5_ids, labels,
                q_mask, t5_mask, dec_mask, method="forward_with_vision",
            ).astype(jnp.float32)
            valid = labels != IGNORE_INDEX
            safe = jnp.where(valid, labels, 0)
            logz = jax.nn.logsumexp(logits, axis=-1)
            picked = jnp.take_along_axis(
                logits, safe[..., None], axis=-1)[..., 0]
            ce = (logz - picked) * valid
            mean_ce = ce.sum(axis=1) / jnp.maximum(valid.sum(axis=1), 1)
            return jnp.exp(-mean_ce)

        self._scores = _scores
        self._encode_vision = _encode_vision
        self._scores_vision = _scores_vision

    def forward(
        self,
        images: Sequence[ImageLike],
        texts: Sequence[str],
        question_template: str = INSTRUCTBLIP_QUESTION_TEMPLATE,
        answer_template: str = INSTRUCTBLIP_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        assert len(images) == len(texts)
        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        q_ids = [
            self.qformer_tokenize(q)[: self.max_txt_len] for q in questions
        ]
        t_ids = [self.t5_tokenize(q)[: self.max_txt_len] for q in questions]
        a_ids = [
            self.t5_tokenize(a)[: self.max_output_txt_len] for a in answers
        ]
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), self.batch_size):
            e = s + self.batch_size
            out[s:e] = self._chunk(
                q_ids[s:e], t_ids[s:e], a_ids[s:e], images[s:e]
            )
        return out

    def _chunk(self, q_ids, t_ids, a_ids, images) -> np.ndarray:
        n = len(q_ids)
        m = self.pad_to_multiple

        def pad_batch(rows, pad_value, multiple):
            width = max(len(r) for r in rows)
            width = ((width + multiple - 1) // multiple) * multiple
            ids = np.full((n, width), pad_value, np.int32)
            mask = np.zeros((n, width), bool)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = True
            return ids, mask

        q, q_mask = pad_batch(q_ids, self.qformer_pad_id, m)
        t, t_mask = pad_batch(t_ids, self.t5_pad_id, m)
        a, dec_mask = pad_batch(a_ids, 0, 8)
        labels = np.where(dec_mask, a, IGNORE_INDEX)
        # reference instructblip preprocess: shortest-edge bicubic resize +
        # center crop + CLIP stats (instructblip_model.py:43-48)
        pixels = preprocess_batch(list(images), self.image_size, "clip")
        return np.asarray(self._scores(
            self.params, jnp.asarray(pixels), jnp.asarray(q),
            jnp.asarray(q_mask), jnp.asarray(t), jnp.asarray(t_mask),
            jnp.asarray(labels), jnp.asarray(dec_mask),
        ))

    def forward_image_texts(
        self,
        image: ImageLike,
        texts: Sequence[str],
        question_template: str = INSTRUCTBLIP_QUESTION_TEMPLATE,
        answer_template: str = INSTRUCTBLIP_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """One image x n texts with the EVA-g tower run ONCE: the Q-Former
        and T5 condition on the candidate text so they run per pair, but the
        vision tower (the largest text-independent FLOPs block, 39 layers x
        1408 wide) is cached — the reference re-runs it per (image, text)
        (instructblip_model.py:80-105)."""
        pixels = preprocess_batch([image], self.image_size, "clip")
        embeds = self._encode_vision(self.params, jnp.asarray(pixels))

        questions = [question_template.format(t) for t in texts]
        answers = [answer_template.format(t) for t in texts]
        q_ids = [
            self.qformer_tokenize(q)[: self.max_txt_len] for q in questions
        ]
        t_ids = [self.t5_tokenize(q)[: self.max_txt_len] for q in questions]
        a_ids = [
            self.t5_tokenize(a)[: self.max_output_txt_len] for a in answers
        ]
        out = np.zeros((len(texts),), np.float32)
        m = self.pad_to_multiple
        for s in range(0, len(texts), self.batch_size):
            e = s + self.batch_size
            n = len(q_ids[s:e])

            def pad_batch(rows, pad_value, multiple):
                width = max(len(r) for r in rows)
                width = ((width + multiple - 1) // multiple) * multiple
                ids = np.full((n, width), pad_value, np.int32)
                mask = np.zeros((n, width), bool)
                for i, r in enumerate(rows):
                    ids[i, : len(r)] = r
                    mask[i, : len(r)] = True
                return ids, mask

            q, q_mask = pad_batch(q_ids[s:e], self.qformer_pad_id, m)
            t, t_mask = pad_batch(t_ids[s:e], self.t5_pad_id, m)
            a, dec_mask = pad_batch(a_ids[s:e], 0, 8)
            labels = np.where(dec_mask, a, IGNORE_INDEX)
            out[s:e] = np.asarray(self._scores_vision(
                self.params, embeds,
                jnp.zeros((n,), jnp.int32),
                jnp.asarray(q), jnp.asarray(q_mask), jnp.asarray(t),
                jnp.asarray(t_mask), jnp.asarray(labels),
                jnp.asarray(dec_mask),
            ))
        return out


# -- CLIP-FlanT5 (encoder-decoder) ----------------------------------------


def format_question_t5(question: str, style: str = "t5_chat") -> str:
    """clip_t5_model.py:12-25 conversation formats."""
    if style == "t5_plain":
        return DEFAULT_IMAGE_TOKEN + question
    if style == "t5_chat":
        return (
            SYSTEM_MSG + " USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question
            + " ASSISTANT: "
        )
    if style == "t5_chat_no_system":
        return "USER: " + DEFAULT_IMAGE_TOKEN + "\n" + question + " ASSISTANT: "
    if style == "t5_chat_no_system_no_user":
        return DEFAULT_IMAGE_TOKEN + "\n" + question + " : "
    raise NotImplementedError(style)


def t5_tokenizer_image_token(
    prompt: str,
    tokenize: TokenizeFn,
    image_token_index: int = IMAGE_TOKEN_INDEX,
) -> List[int]:
    """No-BOS splice variant (mm_utils.py:46-61)."""
    chunks = [tokenize(c) for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: List[int] = []
    for i, chunk in enumerate(chunks):
        ids.extend(chunk)
        if i < len(chunks) - 1:
            ids.append(image_token_index)
    return ids


class T5VQAScorer:
    """VQAScore over a CLIP-FlanT5 model: encoder takes image+question, the
    decoder teacher-forces the answer; score = exp(-mean CE)
    (clip_t5_model.py:221-281).

    Vision-reuse m x n split (forward_image_texts / forward_groups): the CLIP
    vision tower + projector output is text-independent, so each image is
    encoded ONCE and the cached features are spliced into the n per-text
    encoder inputs — the reference re-runs the full vision tower per
    (image, text) pair. The T5 encoder is bidirectional (no KV-prefix trick
    across texts), so the remaining per-pair cost is the T5 encoder+decoder,
    batched over pairs."""

    def __init__(
        self,
        model,  # models.clip_t5.CLIPT5
        params,
        tokenize: TokenizeFn,
        pad_token_id: int = 0,
        conversation_style: str = "t5_chat",
        context_len: int = 2048,
        batch_size: int = 8,
        pad_to_multiple: int = 64,
    ):
        self.model = model
        # commit params to device once — host arrays would re-upload
        # on every jit call
        self.params = jax.device_put(params)
        self.tokenize = tokenize
        self.pad_token_id = pad_token_id
        self.style = conversation_style
        self.context_len = context_len
        self.batch_size = batch_size
        self.pad_to_multiple = pad_to_multiple
        self.image_size = model.cfg.vision.image_size

        def _ce_scores(logits, labels):
            logits = logits.astype(jnp.float32)
            valid = labels != IGNORE_INDEX
            safe = jnp.where(valid, labels, 0)
            logz = jax.nn.logsumexp(logits, axis=-1)
            picked = jnp.take_along_axis(logits, safe[..., None], axis=-1)[..., 0]
            ce = (logz - picked) * valid
            mean_ce = ce.sum(axis=1) / jnp.maximum(valid.sum(axis=1), 1)
            return jnp.exp(-mean_ce)

        @jax.jit
        def _scores(params, input_ids, pixels, enc_mask, labels, dec_mask):
            logits = model.apply(
                {"params": params}, input_ids, pixels, labels,
                enc_mask, dec_mask,
            )
            return _ce_scores(logits, labels)

        @jax.jit
        def _encode_images(params, pixels):
            return model.apply(
                {"params": params}, pixels, method="encode_images"
            )

        @jax.jit
        def _scores_feats(params, input_ids, feats, img_idx, enc_mask,
                          labels, dec_mask):
            # feats [k, n_image, d]; img_idx [B] gathers each pair's image
            logits = model.apply(
                {"params": params}, input_ids, feats[img_idx], labels,
                enc_mask, dec_mask, method="forward_with_features",
            )
            return _ce_scores(logits, labels)

        self._scores = _scores
        self._encode_images = _encode_images
        self._scores_feats = _scores_feats

    def forward(
        self,
        images: Sequence[ImageLike],
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        assert len(images) == len(texts)
        questions = [
            format_question_t5(question_template.format(t), self.style)
            for t in texts
        ]
        answers = [answer_template.format(t) for t in texts]
        q_ids = [
            t5_tokenizer_image_token(q, self.tokenize)[: self.context_len]
            for q in questions
        ]
        a_ids = [self.tokenize(a)[: self.context_len] for a in answers]

        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), self.batch_size):
            out[s : s + self.batch_size] = self._chunk(
                q_ids[s : s + self.batch_size],
                a_ids[s : s + self.batch_size],
                images[s : s + self.batch_size],
            )
        return out

    def _chunk(self, q_ids, a_ids, images) -> np.ndarray:
        n = len(q_ids)
        m = self.pad_to_multiple
        qlen = ((max(len(x) for x in q_ids) + m - 1) // m) * m
        alen = ((max(len(x) for x in a_ids) + 7) // 8) * 8
        input_ids = np.full((n, qlen), self.pad_token_id, np.int32)
        enc_mask = np.zeros((n, qlen), bool)
        labels = np.full((n, alen), IGNORE_INDEX, np.int32)
        dec_mask = np.zeros((n, alen), bool)
        for i in range(n):
            input_ids[i, : len(q_ids[i])] = q_ids[i]
            enc_mask[i, : len(q_ids[i])] = True
            labels[i, : len(a_ids[i])] = a_ids[i]
            dec_mask[i, : len(a_ids[i])] = True
        pixels = preprocess_batch(list(images), self.image_size, "llava")
        return np.asarray(self._scores(
            self.params, jnp.asarray(input_ids), jnp.asarray(pixels),
            jnp.asarray(enc_mask), jnp.asarray(labels), jnp.asarray(dec_mask),
        ))

    # -- image-feature-reuse m x n paths ------------------------------------

    def _tokenize_pairs(self, texts, question_template, answer_template):
        questions = [
            format_question_t5(question_template.format(t), self.style)
            for t in texts
        ]
        answers = [answer_template.format(t) for t in texts]
        q_ids = [
            t5_tokenizer_image_token(q, self.tokenize)[: self.context_len]
            for q in questions
        ]
        a_ids = [self.tokenize(a)[: self.context_len] for a in answers]
        return q_ids, a_ids

    def _pairs_with_features(self, feats, img_idx, q_ids, a_ids) -> np.ndarray:
        """Score pairs (q_ids[p], a_ids[p]) against feats[img_idx[p]],
        batched; feats stays on device across batches."""
        n = len(q_ids)
        out = np.zeros((n,), np.float32)
        for s in range(0, n, self.batch_size):
            qs, as_ = q_ids[s : s + self.batch_size], a_ids[s : s + self.batch_size]
            b = len(qs)
            m = self.pad_to_multiple
            qlen = ((max(len(x) for x in qs) + m - 1) // m) * m
            alen = ((max(len(x) for x in as_) + 7) // 8) * 8
            input_ids = np.full((b, qlen), self.pad_token_id, np.int32)
            enc_mask = np.zeros((b, qlen), bool)
            labels = np.full((b, alen), IGNORE_INDEX, np.int32)
            dec_mask = np.zeros((b, alen), bool)
            for i in range(b):
                input_ids[i, : len(qs[i])] = qs[i]
                enc_mask[i, : len(qs[i])] = True
                labels[i, : len(as_[i])] = as_[i]
                dec_mask[i, : len(as_[i])] = True
            out[s : s + b] = np.asarray(self._scores_feats(
                self.params, jnp.asarray(input_ids), feats,
                jnp.asarray(np.asarray(img_idx[s : s + b], np.int32)),
                jnp.asarray(enc_mask), jnp.asarray(labels),
                jnp.asarray(dec_mask),
            ))
        return out

    def encode_image_features(self, images: Sequence[ImageLike]):
        """Vision tower + projector, ONCE per image (device array [k, n, d])."""
        pixels = preprocess_batch(list(images), self.image_size, "llava")
        return self._encode_images(self.params, jnp.asarray(pixels))

    def forward_image_texts(
        self,
        image: ImageLike,
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """One image x n texts: one vision-tower pass + n batched T5 passes."""
        feats = self.encode_image_features([image])
        q_ids, a_ids = self._tokenize_pairs(
            texts, question_template, answer_template)
        return self._pairs_with_features(
            feats, [0] * len(texts), q_ids, a_ids)

    def forward_groups(
        self,
        images: Sequence[ImageLike],
        texts_per_image: Sequence[Sequence[str]],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        """k images x n texts each -> [k, n]: ONE batched vision pass for
        the k images + batched T5 passes over all k*n pairs."""
        k = len(images)
        n = len(texts_per_image[0])
        assert all(len(t) == n for t in texts_per_image)
        feats = self.encode_image_features(images)
        q_ids, a_ids, img_idx = [], [], []
        for i, texts in enumerate(texts_per_image):
            qi, ai = self._tokenize_pairs(
                texts, question_template, answer_template)
            q_ids.extend(qi)
            a_ids.extend(ai)
            img_idx.extend([i] * n)
        flat = self._pairs_with_features(feats, img_idx, q_ids, a_ids)
        return flat.reshape(k, n)


# -- GPT-4V (API-backed) ------------------------------------------------------


class GPT4VScorer:
    """GPT-4V VQAScore (t2v_metrics gpt4v_model.py:30-140): ask the chat model
    the yes/no question with the image attached, read P(answer) from the
    first generated token's top-logprobs; 0.0 when the answer token is absent
    or the call fails.

    This environment has no egress, so the transport is injectable:
    ``complete(question_text, image_path) -> [(token, logprob), ...]`` — pass
    a thin wrapper over ``openai.OpenAI().chat.completions.create`` in
    production (the reference's exact request shape is documented in its
    forward_single)."""

    def __init__(
        self,
        complete: Callable[[str, str], List],
        top_logprobs: int = 2,
    ):
        self.complete = complete
        self.top_logprobs = top_logprobs

    def forward(
        self,
        images: Sequence[str],
        texts: Sequence[str],
        question_template: str = DEFAULT_QUESTION_TEMPLATE,
        answer_template: str = DEFAULT_ANSWER_TEMPLATE,
    ) -> np.ndarray:
        assert len(images) == len(texts)
        out = np.zeros((len(images),), np.float32)
        for i, (image, text) in enumerate(zip(images, texts)):
            question = question_template.format(text)
            answer = answer_template.format(text)
            try:
                top = self.complete(question, image)
            except Exception:
                continue  # reference returns 0.0 on failure
            for token, logprob in top:
                if token == answer:
                    out[i] = float(np.exp(logprob))
                    break
        return out
