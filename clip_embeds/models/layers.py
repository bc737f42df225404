"""Shared transformer building blocks (flax.linen).

Pre-LN residual blocks matching the reference architecture
(open_clip/src/open_clip/transformer.py:213-268): x += attn(ln_1(x));
x += mlp(ln_2(x)), with QuickGELU for OpenAI-pretrained towers.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..ops.attention import dot_product_attention
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, constrain
from .quant import dense

Dtype = Any


def quick_gelu(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(1.702 * x)


def exact_gelu(x: jax.Array) -> jax.Array:
    # torch nn.GELU default is the exact erf form (flax nn.gelu defaults to
    # the tanh approximation, which breaks checkpoint parity).
    return jax.nn.gelu(x, approximate=False)


def get_act(quick: bool) -> Callable[[jax.Array], jax.Array]:
    return quick_gelu if quick else exact_gelu


class MultiHeadAttention(nn.Module):
    """Packed-QKV multi-head attention (torch nn.MultiheadAttention layout)."""

    width: int
    heads: int
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: bool = False

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        causal: bool = False,
        mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        b, n, _ = x.shape
        head_dim = self.width // self.heads
        qkv = dense(self.quant, 3 * self.width, dtype=self.dtype,
                    name="in_proj")(x)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def split_heads(t):
            # heads ride the model axis under Megatron TP (column-parallel
            # in_proj shards the feature dim = head blocks); anchoring the
            # layout here keeps the partitioner from replicating attention
            # intermediates every block (round-2 SPMD remat warnings)
            t = t.reshape(b, n, self.heads, head_dim).transpose(0, 2, 1, 3)
            return constrain(t, DATA_AXIS, MODEL_AXIS, None, None)

        out = dot_product_attention(
            split_heads(q), split_heads(k), split_heads(v),
            causal=causal, mask=mask, impl=self.attn_impl,
        )
        out = out.transpose(0, 2, 1, 3).reshape(b, n, self.width)
        out = constrain(out, DATA_AXIS, None, MODEL_AXIS)
        return dense(self.quant, self.width, dtype=self.dtype,
                     name="out_proj")(out)


class MLP(nn.Module):
    width: int
    mlp_ratio: float = 4.0
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32
    quant: bool = False

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        hidden = int(self.width * self.mlp_ratio)
        x = dense(self.quant, hidden, dtype=self.dtype, name="c_fc")(x)
        # column-parallel c_fc shards the hidden features over the model axis
        x = constrain(x, DATA_AXIS, None, MODEL_AXIS)
        x = get_act(self.quick_gelu)(x)
        return dense(self.quant, self.width, dtype=self.dtype, name="c_proj")(x)


class ResidualAttentionBlock(nn.Module):
    width: int
    heads: int
    mlp_ratio: float = 4.0
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    quant: bool = False
    ln_eps: float = 1e-5
    # checkpoint_name the attention output (for remat='attn' policies only;
    # annotating unconditionally perturbs every model's HLO and invalidates
    # the persistent compile cache)
    name_attn_out: bool = False

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        causal: bool = False,
        mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        attn = MultiHeadAttention(
            self.width, self.heads, dtype=self.dtype,
            attn_impl=self.attn_impl, quant=self.quant, name="attn",
        )
        a = attn(nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                              name="ln_1")(x),
                 causal=causal, mask=mask)
        if self.name_attn_out:
            from jax.ad_checkpoint import checkpoint_name

            # named so remat='attn' (save_only_these_names) keeps the
            # attention output resident, skipping its forward recompute
            a = checkpoint_name(a, "attn_out")
        # the residual stream stays batch-sharded / feature-replicated (the
        # row-parallel out_proj/c_proj all-reduce lands here)
        x = constrain(x + a, DATA_AXIS, None, None)
        mlp = MLP(self.width, self.mlp_ratio, self.quick_gelu,
                  dtype=self.dtype, quant=self.quant, name="mlp")
        x = constrain(
            x + mlp(nn.LayerNorm(epsilon=self.ln_eps, dtype=self.dtype,
                                 name="ln_2")(x)),
            DATA_AXIS, None, None,
        )
        return x


class Transformer(nn.Module):
    """Stack of residual blocks with optional rematerialization.

    ``num_blocks`` runs only the first k blocks — used for LLaVA's
    hidden_states[-2] feature extraction (llava clip_encoder.py:41-52 selects
    the penultimate layer, i.e. skips the last block).
    """

    width: int
    layers: int
    heads: int
    mlp_ratio: float = 4.0
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False
    quant: bool = False
    ln_eps: float = 1e-5

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        causal: bool = False,
        mask: Optional[jax.Array] = None,
        num_blocks: Optional[int] = None,
    ) -> jax.Array:
        block_cls = ResidualAttentionBlock
        if self.remat:
            # static_argnums counts the bound module as index 0: (self, x,
            # causal, mask) -> causal is index 2. remat='dots' keeps matmul
            # outputs resident and recomputes only elementwise work — most of
            # the no-remat speed at a fraction of the activation memory.
            policy = None
            if self.remat == "dots":
                import jax as _jax

                policy = _jax.checkpoint_policies.                    dots_with_no_batch_dims_saveable
            elif self.remat == "attn":
                import jax as _jax

                # keep per-block attention outputs ([B,N,D] bf16, ~77 MB/
                # layer at ViT-L) resident; everything else recomputes
                policy = _jax.checkpoint_policies.save_only_these_names(
                    "attn_out")
            block_cls = nn.remat(ResidualAttentionBlock, static_argnums=(2,),
                                 policy=policy)
        n = self.layers if num_blocks is None else num_blocks
        for i in range(n):
            block = block_cls(
                self.width, self.heads, self.mlp_ratio, self.quick_gelu,
                dtype=self.dtype, attn_impl=self.attn_impl, quant=self.quant,
                ln_eps=self.ln_eps, name_attn_out=self.remat == "attn",
                name=f"resblocks_{i}",
            )
            x = block(x, causal, mask) if self.remat else block(
                x, causal=causal, mask=mask)
        return x


class _ScanBlock(ResidualAttentionBlock):
    """ResidualAttentionBlock with a (carry, out) signature for nn.scan."""

    def __call__(self, x, causal=False, mask=None):  # type: ignore[override]
        return super().__call__(x, causal=causal, mask=mask), None


class ScanTransformer(nn.Module):
    """lax.scan over stacked block params: one compiled layer body instead of
    an L-times unrolled HLO. Cuts XLA compile size/time dramatically for deep
    towers.

    Params live under 'blocks' with a leading layer axis; use
    stack_block_params() to convert a converted/unrolled tree.
    """

    width: int
    layers: int
    heads: int
    mlp_ratio: float = 4.0
    quick_gelu: bool = False
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    ln_eps: float = 1e-5

    @nn.compact
    def __call__(
        self,
        x: jax.Array,
        causal: bool = False,
        mask: Optional[jax.Array] = None,
    ) -> jax.Array:
        scan = nn.scan(
            _ScanBlock,
            variable_axes={"params": 0},
            split_rngs={"params": True},
            in_axes=(nn.broadcast, nn.broadcast),
            length=self.layers,
        )
        block = scan(
            self.width, self.heads, self.mlp_ratio, self.quick_gelu,
            dtype=self.dtype, attn_impl=self.attn_impl, ln_eps=self.ln_eps,
            name="blocks",
        )
        x, _ = block(x, causal, mask)
        return x


def stack_block_params(transformer_params: dict) -> dict:
    """{'resblocks_0': t0, ...} -> {'blocks': stacked} for ScanTransformer."""
    import numpy as _np

    n = len([k for k in transformer_params if k.startswith("resblocks_")])
    trees = [transformer_params[f"resblocks_{i}"] for i in range(n)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(
        [jnp.asarray(x) for x in xs], axis=0
    ), *trees)
    return {"blocks": stacked}
