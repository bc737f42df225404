"""MobileCLIP-B vision tower (timm ``vit_base_mci_224`` hybrid ViT).

Backs open_clip's ``MobileCLIP-B.json`` (reference
open_clip/src/open_clip/model_configs/MobileCLIP-B.json: timm trunk,
pool 'token', proj null). With proj=null and a non-custom pool, TimmModel
builds the trunk with ``num_classes=embed_dim`` (timm_model.py:52-67), so
the timm classifier head Linear(768, 512, bias=True) IS the CLIP
projection.

Architecture per timm vision_transformer_hybrid.py ``vit_base_mci_224``
(timm is not installed in this image; structure reconstructed from the
published model — the torch replica in tests/test_mobileclip.py encodes
the same contract):

* ConvStem, 3 convs, kernels (4,2,2) == strides, padding 0, GELU:
  3->192 (BN+act), 192->192 (BN+act), 192->768 (bias, no norm/act);
  total stride 16 -> a 14x14 token grid at 224px
* no_embed_class: learned pos embed over the 196 patch tokens only,
  class token prepended AFTER the pos add
* 12 standard pre-LN ViT-B blocks (biased fused qkv, GELU MLP, eps 1e-6)
* final LN, token pooling, head Linear(768 -> 512, bias=True)

Design choice: the stem BatchNorms are folded into the convolutions at
convert time (the reference only runs these towers frozen or converted,
same rationale as resnet.py FrozenBatchNorm), so the JAX graph is pure
conv+bias — no batch_stats collection anywhere in the framework.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

from .timm_vit import TimmViTBlock

Dtype = Any
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class MCiViTConfig:
    image_size: int = 224
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    embed_dim: int = 512

    @property
    def stem_dims(self) -> Tuple[int, int, int]:
        return (self.width // 4, self.width // 4, self.width)


MCI_VIT_SHAPES = {
    "vit_base_mci_224": MCiViTConfig(),
}

_STEM_KERNELS = (4, 2, 2)  # == strides, padding 0 (timm ConvStem for mci)


class MCiViTTower(nn.Module):
    cfg: MCiViTConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        b = images.shape[0]
        x = images.astype(self.dtype)
        for i, (c, k) in enumerate(zip(cfg.stem_dims, _STEM_KERNELS)):
            # BN is folded into the conv bias/kernel at convert time
            x = nn.Conv(c, (k, k), strides=(k, k), padding="VALID",
                        use_bias=True, dtype=self.dtype, name=f"stem_{i}")(x)
            if i < len(cfg.stem_dims) - 1:
                x = nn.gelu(x, approximate=False)
        grid = x.shape[1]
        x = x.reshape(b, grid * grid, cfg.width)
        pos = self.param("pos_embed", nn.initializers.normal(0.02),
                         (grid * grid, cfg.width))
        x = x + pos.astype(self.dtype)  # no_embed_class: patch tokens only
        cls = self.param("cls_token", nn.initializers.normal(0.02),
                         (cfg.width,))
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(self.dtype), (b, 1, cfg.width)), x],
            axis=1)
        block = TimmViTBlock
        if self.remat:
            block = nn.remat(TimmViTBlock)
        for i in range(cfg.depth):
            x = block(cfg.heads, cfg.mlp_ratio, dtype=self.dtype,
                      name=f"blocks_{i}")(x)
        x = nn.LayerNorm(epsilon=LN_EPS, dtype=self.dtype, name="norm")(x)
        pooled = x[:, 0]
        tokens = x[:, 1:]
        pooled = nn.Dense(cfg.embed_dim, use_bias=True, dtype=self.dtype,
                          name="head")(pooled)
        return pooled, tokens


def fold_bn_conv(conv_w: np.ndarray, conv_b, bn: Mapping[str, np.ndarray],
                 eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an inference-mode BatchNorm into the preceding conv.

    conv_w is torch layout [out, in/g, kh, kw]; returns same layout plus a
    per-out-channel bias.
    """
    inv = bn["weight"] / np.sqrt(bn["running_var"] + eps)
    w = conv_w * inv[:, None, None, None]
    b = conv_b if conv_b is not None else np.zeros(conv_w.shape[0],
                                                   conv_w.dtype)
    return w, (b - bn["running_mean"]) * inv + bn["bias"]


def _bn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    from ..core.torch_convert import _np

    return {k: _np(sd[f"{prefix}.{k}"])
            for k in ("weight", "bias", "running_mean", "running_var")}


def _torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)  # [O,I,kh,kw] -> [kh,kw,I,O] (HWIO)


def convert_mci_vit_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip MobileCLIP-B checkpoint (``visual.trunk.*``, timm
    vision_transformer_hybrid naming incl. trunk-head projection) ->
    MCiViTTower params, stem BN folded."""
    from ..core.torch_convert import _layernorm, _linear, _np

    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {}
    for i in range(3):
        pre = f"trunk.patch_embed.backbone.{i}"
        w = _np(sd[pre + ".conv.weight"])
        if f"{pre}.bn.weight" in sd:
            w, b = fold_bn_conv(w, None, _bn(sd, pre + ".bn"))
        else:  # last stem conv: bias, no norm
            b = _np(sd[pre + ".conv.bias"])
        params[f"stem_{i}"] = {"kernel": _torch_conv_to_flax(w), "bias": b}
    width = params["stem_2"]["kernel"].shape[-1]
    params["pos_embed"] = _np(sd["trunk.pos_embed"]).reshape(-1, width)
    params["cls_token"] = _np(sd["trunk.cls_token"]).reshape(-1)
    n = 0
    while f"trunk.blocks.{n}.norm1.weight" in sd:
        n += 1
    for i in range(n):
        pre = f"trunk.blocks.{i}"
        params[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, pre + ".norm1"),
            "qkv": _linear(sd, pre + ".attn.qkv"),
            "attn_proj": _linear(sd, pre + ".attn.proj"),
            "norm2": _layernorm(sd, pre + ".norm2"),
            "fc1": _linear(sd, pre + ".mlp.fc1"),
            "fc2": _linear(sd, pre + ".mlp.fc2"),
        }
    params["norm"] = _layernorm(sd, "trunk.norm")
    params["head"] = _linear(sd, "trunk.head")
    return params
