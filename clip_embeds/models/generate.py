"""Greedy autoregressive generation with a KV cache.

JAX replacement for the reference's generation paths (CoCa.generate,
coca_model.py:286+; t2v VQA models' .generate): prefill the cache with the
prompt in one forward, then a `lax.while_loop` of single-token steps — static
shapes throughout, cache carried as a pytree.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp


def init_cache(model, batch_size: int) -> Any:
    """Zero KV cache pytree for a model (eval_shape only — flax init would
    execute a step and advance the cache index)."""
    shapes = jax.eval_shape(
        lambda: model.init(
            jax.random.PRNGKey(0),
            jnp.zeros((batch_size, 1, model.cfg.hidden_size)), None, None,
            True, method="trunk",
        )["cache"]
    )
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def greedy_generate(
    model,                      # LlamaForCausalLM-compatible
    params: Any,
    input_ids: jax.Array,       # [B, L] prompt (right-aligned, no padding)
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
    inputs_embeds: Optional[jax.Array] = None,
) -> jax.Array:
    """Greedy decode -> [B, max_new_tokens] (padded with eos after stop)."""
    b, prompt_len = input_ids.shape

    def apply(variables, ids=None, embeds=None, positions=None):
        if embeds is None:
            embeds = model.apply(variables, ids, method="embed")
        hidden, updated = model.apply(
            variables, embeds, None, positions, True,
            method="trunk", mutable=["cache"],
        )
        logits = model.apply(variables, hidden[:, -1:], method="logits")
        return logits[:, 0], updated["cache"]

    # prefill: run the whole prompt through the cache
    variables = {"params": params}
    cache = init_cache(model, b)
    prefill_embeds = (
        inputs_embeds
        if inputs_embeds is not None
        else model.apply(variables, input_ids, method="embed")
    )
    n_prefill = prefill_embeds.shape[1]
    positions = jnp.broadcast_to(
        jnp.arange(n_prefill)[None], (b, n_prefill)
    )
    logits, cache = apply(
        {"params": params, "cache": cache},
        embeds=prefill_embeds, positions=positions,
    )
    next_token = jnp.argmax(logits, axis=-1)

    def cond(state):
        step, _, _, done, _ = state
        return jnp.logical_and(step < max_new_tokens - 1, ~jnp.all(done))

    def body(state):
        step, token, cache, done, out = state
        pos = jnp.full((b, 1), n_prefill + step + 1, jnp.int32)
        logits, cache = apply(
            {"params": params, "cache": cache},
            ids=token[:, None], positions=pos,
        )
        nxt = jnp.argmax(logits, axis=-1)
        if eos_token_id is not None:
            done = jnp.logical_or(done, token == eos_token_id)
            nxt = jnp.where(done, eos_token_id, nxt)
        out = out.at[:, step + 1].set(nxt)
        return step + 1, nxt, cache, done, out

    out = jnp.full((b, max_new_tokens), eos_token_id or 0, jnp.int32)
    out = out.at[:, 0].set(next_token)
    done = jnp.zeros((b,), bool)
    if eos_token_id is not None:
        done = next_token == eos_token_id
    _, _, _, _, out = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), next_token, cache, done, out)
    )
    return out


def llava_greedy_generate(
    llava_model,               # models.llava.Llava
    params: Any,
    input_ids: jax.Array,      # [B, L] prompt with one IMAGE_TOKEN_INDEX
    pixel_values: jax.Array,   # [B, S, S, 3]
    max_new_tokens: int,
    eos_token_id: Optional[int] = None,
) -> jax.Array:
    """Greedy caption/answer generation for LLaVA (t2v llava generate path):
    splice image features into the prompt embeddings, then decode through the
    language model's KV cache."""
    image_features = llava_model.apply(
        {"params": params}, pixel_values, method="encode_images"
    )
    embeds = llava_model.apply(
        {"params": params}, input_ids, image_features, method="merge"
    )
    from .llama import LlamaForCausalLM

    lm = LlamaForCausalLM(
        llava_model.cfg.llama, dtype=llava_model.dtype,
        attn_impl=llava_model.attn_impl,
    )
    return greedy_generate(
        lm, params["language_model"], input_ids=jnp.zeros(
            (embeds.shape[0], 0), jnp.int32
        ),
        max_new_tokens=max_new_tokens, eos_token_id=eos_token_id,
        inputs_embeds=embeds,
    )


# -- logits processors / warpers (HF GenerationMixin semantics) --------------


def min_length_process(
    logits: jax.Array, cur_len: jax.Array, min_len: int, eos_token_id: int
) -> jax.Array:
    """MinLengthLogitsProcessor: eos impossible before min_len."""
    return jnp.where(
        (cur_len < min_len)
        & (jnp.arange(logits.shape[-1]) == eos_token_id)[None, :],
        -jnp.inf, logits,
    )


def repetition_penalty_process(
    logits: jax.Array,          # [B, V]
    tokens: jax.Array,          # [B, L] generated-so-far buffer
    token_valid: jax.Array,     # bool [B, L]
    penalty: float,
) -> jax.Array:
    """RepetitionPenaltyLogitsProcessor: scores of already-present tokens are
    divided (if >0) or multiplied (if <0) by the penalty."""
    if penalty == 1.0:
        return logits
    b, v = logits.shape
    presence = jnp.zeros((b, v), bool).at[
        jnp.arange(b)[:, None], jnp.clip(tokens, 0, v - 1)
    ].max(token_valid)
    penalized = jnp.where(logits > 0, logits / penalty, logits * penalty)
    return jnp.where(presence, penalized, logits)


def top_k_warp(logits: jax.Array, k: int) -> jax.Array:
    """TopKLogitsWarper: keep the k largest logits."""
    kth = jnp.sort(logits, axis=-1)[:, -k][:, None]
    return jnp.where(logits < kth, -jnp.inf, logits)


def top_p_warp(logits: jax.Array, p: float, min_tokens_to_keep: int = 1) -> jax.Array:
    """TopPLogitsWarper: keep the smallest set of tokens whose cumulative
    probability exceeds p (ascending-cumsum formulation, HF-exact)."""
    sorted_idx = jnp.argsort(logits, axis=-1)            # ascending
    sorted_logits = jnp.take_along_axis(logits, sorted_idx, axis=-1)
    cum = jnp.cumsum(jax.nn.softmax(sorted_logits, axis=-1), axis=-1)
    remove = cum <= (1.0 - p)
    remove = remove.at[:, -min_tokens_to_keep:].set(False)
    masked_sorted = jnp.where(remove, -jnp.inf, sorted_logits)
    inv = jnp.argsort(sorted_idx, axis=-1)
    return jnp.take_along_axis(masked_sorted, inv, axis=-1)


# -- CoCa generation (coca_model.py:286-411 generate) ------------------------


def coca_sample_generate(
    model,                      # models.coca.CoCa
    params: Any,
    images: jax.Array,          # [B, S, S, 3]
    rng: jax.Array,
    seq_len: int = 30,
    temperature: float = 1.0,
    generation_type: str = "top_p",   # 'top_p' | 'top_k'
    top_p: float = 0.1,
    top_k: int = 1,
    pad_token_id: int = 0,
    eos_token_id: int = 49407,
    sot_token_id: int = 49406,
    min_seq_len: int = 5,
    repetition_penalty: float = 1.0,
) -> jax.Array:
    """Top-k / top-p sampling with min-length + repetition-penalty processors
    (coca_model.py:349-411). Full-prefix recompute per step over a fixed
    buffer — exactly the reference's strategy (it has no KV cache either),
    but under one jit with static shapes. Returns [B, seq_len] (pad-filled
    after eos, eos forced at the last slot like the reference :395-396)."""
    b = images.shape[0]
    variables = {"params": params}
    _, image_embs = model.apply(variables, images, method="image_tokens")

    buffer = jnp.full((b, seq_len), pad_token_id, jnp.int32)
    buffer = buffer.at[:, 0].set(sot_token_id)

    def cond(state):
        step, _, done, _ = state
        return jnp.logical_and(step < seq_len - 1, ~jnp.all(done))

    def body(state):
        step, buf, done, key = state
        logits = model.apply(
            variables, image_embs, buf, method="caption_logits"
        )
        cur = jnp.take_along_axis(
            logits, jnp.full((b, 1, 1), step, jnp.int32).repeat(
                logits.shape[-1], axis=-1
            ), axis=1,
        )[:, 0].astype(jnp.float32)
        cur_len = step + 1
        valid = jnp.arange(seq_len)[None, :] < cur_len
        cur = min_length_process(cur, cur_len, min_seq_len, eos_token_id)
        cur = repetition_penalty_process(cur, buf, valid, repetition_penalty)
        if generation_type == "top_p":
            cur = top_p_warp(cur, top_p)
        elif generation_type == "top_k":
            cur = top_k_warp(cur, top_k)
        else:
            raise ValueError(generation_type)
        key, sub = jax.random.split(key)
        sample = jax.random.categorical(sub, cur / temperature, axis=-1)
        # force eos at the final slot for unfinished rows (:395-396)
        sample = jnp.where(cur_len == seq_len - 1, eos_token_id, sample)
        sample = jnp.where(done, pad_token_id, sample).astype(jnp.int32)
        buf = buf.at[:, cur_len].set(sample)
        done = done | (sample == eos_token_id)
        return cur_len, buf, done, key

    done0 = jnp.zeros((b,), bool)
    _, buffer, _, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), buffer, done0, rng)
    )
    return buffer


def coca_beam_generate(
    model,
    params: Any,
    images: jax.Array,
    seq_len: int = 30,
    num_beams: int = 6,
    pad_token_id: int = 0,
    eos_token_id: int = 49407,
    sot_token_id: int = 49406,
    min_seq_len: int = 5,
    repetition_penalty: float = 1.0,
    length_penalty: float = 1.0,
) -> jax.Array:
    """Static-shape beam search (coca_model.py:413+ _generate_beamsearch).

    Static-shape variant of the HF BeamSearchScorer: finished beams freeze (their
    score stops changing and they emit pads) and candidates compete each step
    over the joint beam x vocab space; the best beam by length-normalized
    score is returned. The reference's num_beam_groups carries no diversity
    penalty, making groups redundant — a single pool is equivalent."""
    b = images.shape[0]
    nb = num_beams
    variables = {"params": params}
    _, image_embs = model.apply(variables, images, method="image_tokens")
    e = image_embs.shape[-1]
    image_embs = jnp.repeat(image_embs, nb, axis=0)  # [B*nb, Q, E]

    buffer = jnp.full((b, nb, seq_len), pad_token_id, jnp.int32)
    buffer = buffer.at[:, :, 0].set(sot_token_id)
    # only beam 0 is live at step 0 (identical prefixes must not duplicate)
    scores = jnp.where(
        jnp.arange(nb)[None, :] == 0, 0.0, -jnp.inf
    ) * jnp.ones((b, 1))
    done = jnp.zeros((b, nb), bool)
    lengths = jnp.ones((b, nb), jnp.int32) * seq_len

    def cond(state):
        step, _, _, done, _ = state
        return jnp.logical_and(step < seq_len - 1, ~jnp.all(done))

    def body(state):
        step, buf, scores, done, lengths = state
        logits = model.apply(
            variables, image_embs, buf.reshape(b * nb, seq_len),
            method="caption_logits",
        )
        vocab = logits.shape[-1]
        cur = logits[:, step].astype(jnp.float32)       # [B*nb, V]
        cur_len = step + 1
        valid = jnp.arange(seq_len)[None, :] < cur_len
        cur = min_length_process(cur, cur_len, min_seq_len, eos_token_id)
        cur = repetition_penalty_process(
            cur, buf.reshape(b * nb, seq_len), valid, repetition_penalty
        )
        logp = jax.nn.log_softmax(cur, axis=-1).reshape(b, nb, vocab)
        # frozen beams contribute exactly one candidate: a pad continuation
        # that keeps their score
        cand = scores[:, :, None] + logp                 # [B, nb, V]
        pad_col = (jnp.arange(vocab) == pad_token_id)[None, None, :]
        cand = jnp.where(
            done[:, :, None], jnp.where(pad_col, scores[:, :, None], -jnp.inf),
            cand,
        )
        flat = cand.reshape(b, nb * vocab)
        top_scores, top_idx = jax.lax.top_k(flat, nb)
        beam_idx = top_idx // vocab
        token = (top_idx % vocab).astype(jnp.int32)
        buf = jnp.take_along_axis(buf, beam_idx[:, :, None], axis=1)
        new_done = jnp.take_along_axis(done, beam_idx, axis=1)
        new_lengths = jnp.take_along_axis(lengths, beam_idx, axis=1)
        token = jnp.where(new_done, pad_token_id, token)
        buf = buf.at[:, :, cur_len].set(token)
        finished_now = (~new_done) & (token == eos_token_id)
        new_lengths = jnp.where(finished_now, cur_len + 1, new_lengths)
        new_done = new_done | finished_now
        return cur_len, buf, top_scores, new_done, new_lengths

    _, buffer, scores, done, lengths = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), buffer, scores, done, lengths)
    )
    norm = scores / (lengths.astype(jnp.float32) ** length_penalty)
    best = jnp.argmax(norm, axis=1)
    return jnp.take_along_axis(buffer, best[:, None, None], axis=1)[:, 0]
