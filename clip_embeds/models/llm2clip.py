"""LLM2CLIP (microsoft/LLM2CLIP-Openai-L-14-336): CLIP ViT-L vision tower +
an MLP adapter that maps precomputed LLM2Vec text embeddings into the CLIP
space.

Reference usage: open_clip/src/llm2clip-test.py:19-72 —
``model.get_image_features(pixels)`` and
``model.get_text_features(l2v.encode(texts))`` followed by the standard
100*cosine softmax What'sUp scoring; PACL's llm2clip variants tap
``vision_model.last_hidden_state`` patches (pacl.py:212-291).

The text side is the public LLM2CLIP adapter: N pre-LN residual MLP blocks
(LinearBlock: x + fc2(drop(gelu(fc1(ln(x)))))) followed by LayerNorm + Linear
to the CLIP width. The converter infers block count / expansion from the
checkpoint and raises on an unexpected layout (the remote-code file is not
vendored in the reference, so structure is validated at load)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
from .._vendor.flax import linen as nn

from ..core.config import VisionConfig
from .clip import l2_normalize
from .layers import exact_gelu
from .vit import VisionTransformer

Dtype = Any


@dataclasses.dataclass(frozen=True)
class LLM2CLIPConfig:
    vision: VisionConfig = dataclasses.field(
        default_factory=lambda: VisionConfig(
            image_size=336, patch_size=14, width=1024, layers=24
        )
    )
    embed_dim: int = 1280              # CLIP joint space
    text_embedding_dim: int = 4096     # LLM2Vec (Llama-3-8B) output
    adaptor_layers: int = 4
    expansion_factor: int = 2
    vision_quick_gelu: bool = True


class LinearBlock(nn.Module):
    """x + fc2(gelu(fc1(ln(x)))) — the LLM2CLIP adapter block."""

    dim: int
    expansion_factor: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        h = nn.LayerNorm(epsilon=1e-5, dtype=self.dtype, name="ln")(x)
        h = nn.Dense(self.dim * self.expansion_factor, dtype=self.dtype,
                     name="fc1")(h)
        h = exact_gelu(h)
        h = nn.Dense(self.dim, dtype=self.dtype, name="fc2")(h)
        return x + h


class LLM2CLIP(nn.Module):
    cfg: LLM2CLIPConfig
    dtype: Dtype = jnp.float32
    attn_impl: str = "auto"
    remat: bool = False

    def setup(self):
        self.vision_model = VisionTransformer(
            self.cfg.vision, embed_dim=self.cfg.embed_dim,
            quick_gelu=self.cfg.vision_quick_gelu, dtype=self.dtype,
            attn_impl=self.attn_impl, remat=self.remat,
        )
        self.blocks = [
            LinearBlock(self.cfg.text_embedding_dim,
                        self.cfg.expansion_factor, dtype=self.dtype,
                        name=f"adaptor_{i}")
            for i in range(self.cfg.adaptor_layers)
        ]
        self.final_ln = nn.LayerNorm(
            epsilon=1e-5, dtype=self.dtype, name="final_ln"
        )
        self.text_projection = nn.Dense(
            self.cfg.embed_dim, dtype=self.dtype, name="text_projection"
        )

    def get_image_features(
        self, pixel_values: jax.Array, normalize: bool = False
    ) -> jax.Array:
        """[B, S, S, 3] -> [B, embed_dim] (pooled CLS -> visual projection)."""
        pooled, _ = self.vision_model(pixel_values)
        return l2_normalize(pooled) if normalize else pooled

    def image_patches(self, pixel_values: jax.Array) -> jax.Array:
        """Raw patch hidden states [B, N, width] for the PACL heads
        (pacl.py:236-241 vision_model last_hidden_state[:, 1:])."""
        hidden = self.vision_model(pixel_values, hidden_layer=-1)
        return hidden[:, 1:]

    def get_text_features(
        self, llm_embeddings: jax.Array, normalize: bool = False
    ) -> jax.Array:
        """LLM2Vec embeddings [B, text_embedding_dim] -> [B, embed_dim]."""
        x = llm_embeddings.astype(self.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.text_projection(self.final_ln(x))
        return l2_normalize(x) if normalize else x

    def __call__(
        self, pixel_values: jax.Array, llm_embeddings: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        return (
            self.get_image_features(pixel_values, normalize=True),
            self.get_text_features(llm_embeddings, normalize=True),
        )


def convert_llm2clip_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF LLM2CLIP checkpoint -> LLM2CLIP params.

    Expected keys: vision_model.* (HF CLIPVisionModel),
    visual_projection.weight, and text_adapter.adaptor.{i}.* where blocks
    0..N-1 are LinearBlocks (ln + fn.0/fn.3 linears), block N a LayerNorm and
    block N+1 the output Linear. Infers N; raises KeyError on a different
    layout so silent mis-conversion is impossible."""
    import numpy as np

    from ..core.torch_convert import (
        _linear,
        _layernorm,
        _np,
        convert_hf_clip_vision_state_dict,
    )

    sd = dict(sd)
    vision = convert_hf_clip_vision_state_dict(sd, prefix="vision_model.")
    vision["proj"] = _np(sd["visual_projection.weight"]).T

    n = 0
    while f"text_adapter.adaptor.{n}.fn.0.weight" in sd:
        n += 1
    if n == 0:
        raise KeyError(
            "text_adapter.adaptor.0.fn.0.weight missing — unexpected "
            "LLM2CLIP adapter layout"
        )
    params: Dict[str, Any] = {"vision_model": vision}
    for i in range(n):
        pre = f"text_adapter.adaptor.{i}"
        params[f"adaptor_{i}"] = {
            "ln": _layernorm(sd, f"{pre}.ln"),
            "fc1": _linear(sd, f"{pre}.fn.0"),
            "fc2": _linear(sd, f"{pre}.fn.3"),
        }
    params["final_ln"] = _layernorm(sd, f"text_adapter.adaptor.{n}")
    params["text_projection"] = _linear(sd, f"text_adapter.adaptor.{n + 1}")
    return params
