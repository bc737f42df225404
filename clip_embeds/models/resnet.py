"""ModifiedResNet vision tower (CLIP RN50 family) in flax.linen.

Reference: open_clip/src/open_clip/modified_resnet.py — 3-conv stem with
avgpool, antialiased strided bottlenecks (avgpool before the stride-2 conv,
:11-56), and the QKV attention pool whose query is the mean token
(:59-94 AttentionPool2d; only the query token's output is returned, so the
single-query form here is mathematically identical).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

Dtype = Any


def _avg_pool(x: jax.Array, window: int) -> jax.Array:
    return nn.avg_pool(x, (window, window), strides=(window, window))


class FrozenBatchNorm(nn.Module):
    """BatchNorm with running statistics stored as (non-decayed) params.

    Matches inference-mode torch BN / torchvision FrozenBatchNorm2d. The
    reference only ever runs RN towers frozen or converted (LiT lock,
    modified_resnet.py:162-167), so stats-as-params keeps the whole framework
    on a single params collection.
    """

    epsilon: float = 1e-5
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        c = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (c,))
        bias = self.param("bias", nn.initializers.zeros, (c,))
        mean = self.param("mean", nn.initializers.zeros, (c,))
        var = self.param("var", nn.initializers.ones, (c,))
        inv = jax.lax.rsqrt(var + self.epsilon) * scale
        return (x - mean.astype(x.dtype)) * inv.astype(x.dtype) + bias.astype(x.dtype)


class ConvBN(nn.Module):
    features: int
    kernel: int
    stride: int = 1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        pad = (self.kernel - 1) // 2
        x = nn.Conv(
            self.features, (self.kernel, self.kernel),
            strides=(self.stride, self.stride),
            padding=[(pad, pad), (pad, pad)], use_bias=False,
            dtype=self.dtype, name="conv",
        )(x)
        return FrozenBatchNorm(dtype=self.dtype, name="bn")(x)


class Bottleneck(nn.Module):
    planes: int
    stride: int = 1
    expansion: int = 4
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, train: bool = False) -> jax.Array:
        out_ch = self.planes * self.expansion
        identity = x
        out = nn.relu(ConvBN(self.planes, 1, dtype=self.dtype, name="c1")(x, train))
        out = nn.relu(ConvBN(self.planes, 3, dtype=self.dtype, name="c2")(out, train))
        if self.stride > 1:
            out = _avg_pool(out, self.stride)
        out = ConvBN(out_ch, 1, dtype=self.dtype, name="c3")(out, train)

        if self.stride > 1 or x.shape[-1] != out_ch:
            if self.stride > 1:
                identity = _avg_pool(identity, self.stride)
            identity = ConvBN(out_ch, 1, dtype=self.dtype, name="downsample")(
                identity, train
            )
        return nn.relu(out + identity)


class AttentionPool2d(nn.Module):
    embed_dim: int
    num_heads: int
    output_dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        """[B, H, W, C] -> [B, output_dim] via mean-query attention."""
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = jnp.concatenate(
            [tokens.mean(axis=1, keepdims=True), tokens], axis=1
        )  # [B, 1+HW, C]
        pos = self.param(
            "positional_embedding",
            nn.initializers.normal(c ** -0.5),
            (h * w + 1, c),
        )
        tokens = tokens + pos.astype(tokens.dtype)

        q = nn.Dense(self.embed_dim, dtype=self.dtype, name="q_proj")(
            tokens[:, :1]
        )
        k = nn.Dense(self.embed_dim, dtype=self.dtype, name="k_proj")(tokens)
        v = nn.Dense(self.embed_dim, dtype=self.dtype, name="v_proj")(tokens)

        hd = self.embed_dim // self.num_heads
        q = q.reshape(b, 1, self.num_heads, hd).transpose(0, 2, 1, 3)
        k = k.reshape(b, -1, self.num_heads, hd).transpose(0, 2, 1, 3)
        v = v.reshape(b, -1, self.num_heads, hd).transpose(0, 2, 1, 3)
        logits = jnp.einsum(
            "bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32
        ) * (hd ** -0.5)
        probs = jax.nn.softmax(logits, axis=-1).astype(v.dtype)
        out = jnp.einsum("bhqk,bhkd->bhqd", probs, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, 1, self.embed_dim)[:, 0]
        return nn.Dense(self.output_dim, dtype=self.dtype, name="c_proj")(out)


class ModifiedResNet(nn.Module):
    layers: Sequence[int]
    output_dim: int
    heads: int
    image_size: int = 224
    width: int = 64
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(
        self, images: jax.Array, train: bool = False
    ) -> Tuple[jax.Array, jax.Array]:
        """[B, H, W, 3] -> (pooled [B, output_dim], final grid tokens)."""
        x = images.astype(self.dtype)
        x = nn.relu(ConvBN(self.width // 2, 3, 2, self.dtype, name="stem1")(x, train))
        x = nn.relu(ConvBN(self.width // 2, 3, 1, self.dtype, name="stem2")(x, train))
        x = nn.relu(ConvBN(self.width, 3, 1, self.dtype, name="stem3")(x, train))
        x = _avg_pool(x, 2)

        planes = self.width
        for stage, blocks in enumerate(self.layers):
            stride = 1 if stage == 0 else 2
            for i in range(blocks):
                x = Bottleneck(
                    planes, stride if i == 0 else 1, dtype=self.dtype,
                    name=f"layer{stage + 1}_{i}",
                )(x, train)
            planes *= 2

        embed_dim = self.width * 32
        pooled = AttentionPool2d(
            embed_dim, self.heads, self.output_dim, dtype=self.dtype,
            name="attnpool",
        )(x)
        b, h, w, c = x.shape
        return pooled, x.reshape(b, h * w, c)
