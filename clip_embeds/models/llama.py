"""Llama decoder (flax.linen) for the LLaVA-1.5 stack.

JAX equivalent of the vendored HF Llama used by the reference's
VQAScore/VLM2Vec paths (t2v_metrics llava_model.py:354 LlamaModel forward;
VLM2Vec/src/vlm_backbone). Teacher-forced forward only — VQAScore is
P(answer | image, question) via cross-entropy (llava_model.py:359-370), no
generation loop needed for the benchmarks.

Architecture: RMSNorm, rotate-half RoPE, SwiGLU MLP, optional GQA, causal
attention with per-sample padding masks. Matmul layouts follow flax Dense so
the HF converter is a plain transpose; Megatron TP specs come from
parallel/sharding_rules.py conventions (in_proj-style column/row splits).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..ops.attention import dot_product_attention

Dtype = Any


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style q/k/v biases
    # Qwen2-VL multimodal RoPE: per-axis (t, h, w) channel sections summing to
    # head_dim/2 (modeling_qwen2_vl.py:489-531). None -> standard 1D RoPE.
    mrope_section: Optional[Tuple[int, ...]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


def llama_7b_config() -> LlamaConfig:
    return LlamaConfig()


def llama_tiny_config() -> LlamaConfig:
    return LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=128,
    )


class RMSNorm(nn.Module):
    eps: float = 1e-5
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x32 = x.astype(jnp.float32)
        var = jnp.mean(x32 * x32, axis=-1, keepdims=True)
        x32 = x32 * jax.lax.rsqrt(var + self.eps)
        weight = self.param("weight", nn.initializers.ones, (x.shape[-1],))
        return (weight * x32).astype(self.dtype)


def rope_cos_sin(
    positions: jax.Array, head_dim: int, theta: float
) -> Tuple[jax.Array, jax.Array]:
    """positions [B, N] -> (cos, sin) [B, N, head_dim] (HF rotate-half layout)."""
    inv_freq = 1.0 / (
        theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    )
    angles = positions[..., None].astype(jnp.float32) * inv_freq  # [B,N,hd/2]
    emb = jnp.concatenate([angles, angles], axis=-1)
    return jnp.cos(emb), jnp.sin(emb)


def mrope_cos_sin(
    positions: jax.Array,           # [B, 3, N] (t, h, w) position ids
    head_dim: int,
    theta: float,
    section: Tuple[int, ...],
) -> Tuple[jax.Array, jax.Array]:
    """Multimodal RoPE: interleave per-axis rotations along the channel dim
    (apply_multimodal_rotary_pos_emb, modeling_qwen2_vl.py:489-531 — the
    [hd] channels split into sections*2 cycling t/h/w)."""
    import numpy as np

    inv_freq = 1.0 / (
        theta ** (jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    )
    angles = positions[..., None].astype(jnp.float32) * inv_freq  # [B,3,N,hd/2]
    emb = jnp.concatenate([angles, angles], axis=-1)              # [B,3,N,hd]
    sel = np.concatenate(
        [np.full(s, i % 3) for i, s in enumerate(list(section) * 2)]
    )
    assert sel.shape[0] == head_dim, (sel.shape, head_dim)
    onehot = jax.nn.one_hot(jnp.asarray(sel), 3, dtype=jnp.float32)  # [hd, 3]
    cos = jnp.einsum("bsnd,ds->bnd", jnp.cos(emb), onehot)
    sin = jnp.einsum("bsnd,ds->bnd", jnp.sin(emb), onehot)
    return cos, sin


def apply_rotary(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x [B, H, N, D]; cos/sin [B, N, D]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = jnp.concatenate([-x2, x1], axis=-1)
    return x * cos[:, None, :, :].astype(x.dtype) + rotated * sin[:, None, :, :].astype(x.dtype)


class LlamaAttention(nn.Module):
    cfg: LlamaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: str = ""  # '' | 'dynamic' | 'static' W8A8 projections (quant.py)
    lora_rank: int = 0       # unmaterialized LoRA side-path (quant.py dense)
    lora_alpha: float = 16.0

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        cos: jax.Array,
        sin: jax.Array,
        kv_mask: Optional[jax.Array],
        decode: bool = False,
        prefix: Optional[Tuple[jax.Array, jax.Array]] = None,
        sow_kv: bool = False,
        prefix_mask: Optional[jax.Array] = None,
        suffix_block: Optional[int] = None,
    ) -> jax.Array:
        from .quant import dense as make_dense

        cfg = self.cfg
        b, n, _ = x.shape
        hd = cfg.head_dim
        qkv_bias = cfg.attention_bias
        lr, la = self.lora_rank, self.lora_alpha
        q = make_dense(self.quant, cfg.num_heads * hd, use_bias=qkv_bias,
                       dtype=self.dtype, name="q_proj",
                       lora_rank=lr, lora_alpha=la)(x)
        k = make_dense(self.quant, cfg.kv_heads * hd, use_bias=qkv_bias,
                       dtype=self.dtype, name="k_proj",
                       lora_rank=lr, lora_alpha=la)(x)
        v = make_dense(self.quant, cfg.kv_heads * hd, use_bias=qkv_bias,
                       dtype=self.dtype, name="v_proj",
                       lora_rank=lr, lora_alpha=la)(x)

        q = q.reshape(b, n, cfg.num_heads, hd).transpose(0, 2, 1, 3)
        k = k.reshape(b, n, cfg.kv_heads, hd).transpose(0, 2, 1, 3)
        v = v.reshape(b, n, cfg.kv_heads, hd).transpose(0, 2, 1, 3)

        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)

        if sow_kv:
            # expose post-RoPE, pre-GQA-repeat K/V (the reusable part of the
            # image+question prefix — VQAScore m x n KV-prefix reuse,
            # replacing the reference's per-pair full re-forward at
            # t2v_metrics score.py:43-57 / llava_model.py:289-370)
            self.sow("kv", "k", k.astype(self.dtype))
            self.sow("kv", "v", v.astype(self.dtype))

        if prefix is not None:
            # suffix pass over a cached prefix: queries are the n suffix
            # tokens; keys/values are [broadcast prefix KV ++ suffix KV].
            # The prefix KV rides at batch 1 and broadcasts across the
            # candidate-text batch — the image is encoded once per image,
            # not once per (image, text) pair.
            pk, pv = prefix
            pmask = prefix_mask
            pk = jnp.broadcast_to(pk, (b,) + pk.shape[1:])
            pv = jnp.broadcast_to(pv, (b,) + pv.shape[1:])
            p_len = pk.shape[2]
            k_all = jnp.concatenate([pk, k], axis=2)
            v_all = jnp.concatenate([pv, v], axis=2)
            if cfg.kv_heads != cfg.num_heads:
                rep = cfg.num_heads // cfg.kv_heads
                k_all = jnp.repeat(k_all, rep, axis=1)
                v_all = jnp.repeat(v_all, rep, axis=1)
            # [B, 1, n, P+n]: prefix fully visible, causal within the
            # suffix. suffix_block=k restricts suffix attention to
            # block-diagonal causal: n_texts independent k-token candidate
            # suffixes CONCATENATED in one row all read the same prefix KV
            # without replicating it (the batched m x n eval layout).
            i = jnp.arange(n)[:, None]
            j = jnp.arange(p_len + n)[None, :]
            js = j - p_len
            within = js <= i
            if suffix_block is not None:
                within = jnp.logical_and(
                    within, (js // suffix_block) == (i // suffix_block))
            mask = (j < p_len) | within
            mask = jnp.broadcast_to(mask[None, None], (b, 1, n, p_len + n))
            ok_parts = []
            if pmask is not None:  # right-padded prefill slots
                ok_parts.append(
                    jnp.broadcast_to(pmask.astype(bool), (b, p_len)))
            else:
                ok_parts.append(jnp.ones((b, p_len), bool))
            if kv_mask is not None:  # suffix padding
                ok_parts.append(kv_mask.astype(bool))
            else:
                ok_parts.append(jnp.ones((b, n), bool))
            ok = jnp.concatenate(ok_parts, axis=1)
            mask = jnp.logical_and(mask, ok[:, None, None, :])
            out = dot_product_attention(
                q, k_all, v_all, causal=False, mask=mask, impl=self.attn_impl
            )
            out = out.transpose(0, 2, 1, 3).reshape(b, n, cfg.num_heads * hd)
            return make_dense(self.quant, cfg.hidden_size, use_bias=False,
                              dtype=self.dtype, name="o_proj",
                              lora_rank=lr, lora_alpha=la)(out)

        if decode:
            # autoregressive KV cache (flax 'cache' collection): append this
            # chunk's k/v at the write index and attend over the filled prefix
            max_len = cfg.max_position_embeddings
            cache_k = self.variable(
                "cache", "cached_k",
                lambda: jnp.zeros((b, cfg.kv_heads, max_len, hd), self.dtype),
            )
            cache_v = self.variable(
                "cache", "cached_v",
                lambda: jnp.zeros((b, cfg.kv_heads, max_len, hd), self.dtype),
            )
            idx_var = self.variable(
                "cache", "cache_index", lambda: jnp.zeros((), jnp.int32)
            )
            idx = idx_var.value
            cache_k.value = jax.lax.dynamic_update_slice(
                cache_k.value, k.astype(self.dtype), (0, 0, idx, 0)
            )
            cache_v.value = jax.lax.dynamic_update_slice(
                cache_v.value, v.astype(self.dtype), (0, 0, idx, 0)
            )
            idx_var.value = idx + n
            k_all, v_all = cache_k.value, cache_v.value
            if cfg.kv_heads != cfg.num_heads:
                rep = cfg.num_heads // cfg.kv_heads
                k_all = jnp.repeat(k_all, rep, axis=1)
                v_all = jnp.repeat(v_all, rep, axis=1)
            # key j visible to query i (absolute position idx+i) iff j <= idx+i
            key_pos = jnp.arange(max_len)[None, None, None, :]
            q_pos = (idx + jnp.arange(n))[None, None, :, None]
            mask = key_pos <= q_pos
            if kv_mask is not None:
                mask = jnp.logical_and(mask, kv_mask[:, None, None, :])
            out = dot_product_attention(
                q, k_all, v_all, causal=False, mask=mask, impl="reference"
            )
        else:
            if cfg.kv_heads != cfg.num_heads:
                rep = cfg.num_heads // cfg.kv_heads
                k = jnp.repeat(k, rep, axis=1)
                v = jnp.repeat(v, rep, axis=1)
            mask = None
            if kv_mask is not None:
                mask = kv_mask[:, None, None, :]
            out = dot_product_attention(
                q, k, v, causal=True, mask=mask, impl=self.attn_impl
            )
        out = out.transpose(0, 2, 1, 3).reshape(b, n, cfg.num_heads * hd)
        return make_dense(self.quant, cfg.hidden_size, use_bias=False,
                          dtype=self.dtype, name="o_proj",
                          lora_rank=lr, lora_alpha=la)(out)


class LlamaMLP(nn.Module):
    cfg: LlamaConfig
    dtype: Dtype = jnp.float32
    quant: str = ""
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        from .quant import dense as make_dense

        cfg = self.cfg
        lr, la = self.lora_rank, self.lora_alpha
        gate = make_dense(self.quant, cfg.intermediate_size, use_bias=False,
                          dtype=self.dtype, name="gate_proj",
                          lora_rank=lr, lora_alpha=la)(x)
        up = make_dense(self.quant, cfg.intermediate_size, use_bias=False,
                        dtype=self.dtype, name="up_proj",
                        lora_rank=lr, lora_alpha=la)(x)
        return make_dense(self.quant, cfg.hidden_size, use_bias=False,
                          dtype=self.dtype, name="down_proj",
                          lora_rank=lr, lora_alpha=la)(
            jax.nn.silu(gate) * up)


class LlamaBlock(nn.Module):
    cfg: LlamaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: str = ""
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @nn.compact
    def __call__(self, x, cos, sin, kv_mask, decode: bool = False,
                 prefix=None, sow_kv: bool = False, prefix_mask=None,
                 suffix_block=None):
        h = RMSNorm(self.cfg.rms_norm_eps, self.dtype,
                    name="input_layernorm")(x)
        x = x + LlamaAttention(self.cfg, self.dtype, self.attn_impl,
                               self.quant, lora_rank=self.lora_rank,
                               lora_alpha=self.lora_alpha,
                               name="self_attn")(h, cos, sin, kv_mask, decode,
                                                 prefix, sow_kv, prefix_mask,
                                                 suffix_block)
        h = RMSNorm(self.cfg.rms_norm_eps, self.dtype,
                    name="post_attention_layernorm")(x)
        return x + LlamaMLP(self.cfg, self.dtype, self.quant,
                            lora_rank=self.lora_rank,
                            lora_alpha=self.lora_alpha, name="mlp")(h)


class _ScanLlamaBlock(LlamaBlock):
    """LlamaBlock with a (carry, out) signature for nn.scan; the per-layer
    prefix KV (if any) rides as the scanned input."""

    def __call__(self, x, scanned, cos, sin, kv_mask, sow_kv=False,  # type: ignore[override]
                 prefix_mask=None, suffix_block=None):
        prefix = None
        if scanned:  # {} when no prefix is scanned
            prefix = (scanned["k"], scanned["v"])
        y = super().__call__(x, cos, sin, kv_mask, False, prefix, sow_kv,
                             prefix_mask, suffix_block)
        return y, None


class LlamaModel(nn.Module):
    """Decoder trunk operating on input embeddings (LLaVA splices image
    features before this — llava_arch.py:96-200 equivalent)."""

    cfg: LlamaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant: str = ""
    lora_rank: int = 0       # unmaterialized LoRA over the trunk projections
    lora_alpha: float = 16.0
    scan_layers: bool = False  # lax.scan over stacked block params: one
    # compiled layer body instead of an L-times unrolled HLO (32x smaller
    # compile for the 7B trunk; params under 'blocks' — stack_llama_params)

    @nn.compact
    def __call__(
        self,
        inputs_embeds: jax.Array,            # [B, N, D]
        attention_mask: Optional[jax.Array] = None,  # bool [B, N] (in decode
                                                     # mode: over the cache)
        positions: Optional[jax.Array] = None,       # int [B, N]
        decode: bool = False,
        prefix_kv: Optional[Any] = None,     # per-layer ((k, v), ...), or
                                             # stacked ([L,...] K, V) under
                                             # scan_layers
        sow_kv: bool = False,
        prefix_mask: Optional[jax.Array] = None,  # bool [Bp, P] over the
                                             # (padded) cached prefix
        suffix_block: Optional[int] = None,  # block-diagonal causal suffix
                                             # (concatenated candidates)
    ) -> jax.Array:
        cfg = self.cfg
        b, n, _ = inputs_embeds.shape
        if positions is None:
            positions = jnp.broadcast_to(jnp.arange(n)[None, :], (b, n))
        if cfg.mrope_section is not None and positions.ndim == 3:
            cos, sin = mrope_cos_sin(
                positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_section
            )
        else:
            if positions.ndim == 3:  # mrope-shaped ids on a 1D-RoPE model
                positions = positions[:, 0]
            cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)

        x = inputs_embeds
        if self.scan_layers:
            assert not decode and not self.remat, (
                "scan_layers supports the forward / prefill / suffix paths"
            )
            if prefix_kv is None:
                scanned = {}
                in_ax = 0
            else:
                k_all, v_all = prefix_kv  # stacked [L, Bp, H, P, hd]
                scanned = {"k": k_all, "v": v_all}
                in_ax = 0
            scan = nn.scan(
                _ScanLlamaBlock,
                variable_axes={"params": 0, "kv": 0, "quant_obs": 0,
                               "lora": 0},
                split_rngs={"params": True},
                in_axes=(in_ax, nn.broadcast, nn.broadcast, nn.broadcast,
                         nn.broadcast, nn.broadcast, nn.broadcast),
                length=cfg.num_layers,
            )
            x, _ = scan(cfg, self.dtype, self.attn_impl, self.quant,
                        self.lora_rank, self.lora_alpha,
                        name="blocks")(
                x, scanned, cos, sin, attention_mask, sow_kv, prefix_mask,
                suffix_block)
            return RMSNorm(cfg.rms_norm_eps, self.dtype, name="norm")(x)
        block_cls = LlamaBlock
        if self.remat:
            # remat is a training feature; the prefix/sow_kv serving paths
            # never run under it (their non-pytree args would need static
            # marking under jax.checkpoint). `decode` (arg 5 counting the
            # module instance) is a Python bool and must stay static.
            assert prefix_kv is None and not sow_kv
            block_cls = nn.remat(LlamaBlock, static_argnums=(5,))
        for i in range(cfg.num_layers):
            if prefix_kv is None and not sow_kv:
                x = block_cls(cfg, self.dtype, self.attn_impl, self.quant,
                              self.lora_rank, self.lora_alpha,
                              name=f"layers_{i}")(x, cos, sin, attention_mask,
                                                  decode)
            else:
                x = block_cls(cfg, self.dtype, self.attn_impl, self.quant,
                              self.lora_rank, self.lora_alpha,
                              name=f"layers_{i}")(
                    x, cos, sin, attention_mask, decode,
                    None if prefix_kv is None else prefix_kv[i], sow_kv,
                    prefix_mask, suffix_block)
        return RMSNorm(cfg.rms_norm_eps, self.dtype, name="norm")(x)


class LlamaForCausalLM(nn.Module):
    cfg: LlamaConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant: str = ""
    lora_rank: int = 0       # LoRA over trunk projections only (the
    # reference's target set: q/k/v/o/gate/up/down — embeddings and lm_head
    # stay frozen, VLM2Vec/src/model.py:108-115)
    lora_alpha: float = 16.0
    scan_layers: bool = False

    def setup(self):
        self.embed_tokens = nn.Embed(
            self.cfg.vocab_size, self.cfg.hidden_size,
            embedding_init=nn.initializers.normal(0.02), dtype=self.dtype,
            name="embed_tokens",
        )
        self.model = LlamaModel(
            self.cfg, self.dtype, self.attn_impl, self.remat, self.quant,
            self.lora_rank, self.lora_alpha, self.scan_layers, name="model"
        )
        if not self.cfg.tie_word_embeddings:
            self.lm_head = nn.Dense(
                self.cfg.vocab_size, use_bias=False, dtype=self.dtype,
                name="lm_head",
            )

    def embed(self, input_ids: jax.Array) -> jax.Array:
        return self.embed_tokens(input_ids)

    def trunk(
        self,
        inputs_embeds: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        positions: Optional[jax.Array] = None,
        decode: bool = False,
        prefix_kv: Optional[Any] = None,
        sow_kv: bool = False,
        prefix_mask: Optional[jax.Array] = None,
        suffix_block: Optional[int] = None,
    ) -> jax.Array:
        return self.model(inputs_embeds, attention_mask, positions, decode,
                          prefix_kv, sow_kv, prefix_mask, suffix_block)

    def logits(self, hidden: jax.Array) -> jax.Array:
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.attend(hidden)
        return self.lm_head(hidden)

    def __call__(
        self,
        input_ids: jax.Array,
        attention_mask: Optional[jax.Array] = None,
        positions: Optional[jax.Array] = None,
    ) -> jax.Array:
        h = self.trunk(self.embed(input_ids), attention_mask, positions)
        return self.logits(h)


def stack_llama_params(params: dict) -> dict:
    """Unrolled LlamaForCausalLM params -> scan_layers layout:
    {'model': {'layers_0': t0, ..., 'norm': n}} becomes
    {'model': {'blocks': stacked, 'norm': n}} (embed/lm_head unchanged)."""
    out = dict(params)
    model = dict(params["model"])
    n = len([k for k in model if k.startswith("layers_")])
    trees = [model.pop(f"layers_{i}") for i in range(n)]
    model["blocks"] = jax.tree.map(
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs], axis=0), *trees
    )
    out["model"] = model
    return out
