"""FastViT-MCI vision towers (MobileCLIP-S1/S2 image encoders).

Backs open_clip's ``MobileCLIP-S1.json`` / ``MobileCLIP-S2.json``
(reference open_clip/src/open_clip/model_configs/MobileCLIP-S*.json:
``timm_model_name: fastvit_mci1|fastvit_mci2``, pool 'avg', proj null).
With proj=null and a non-custom pool, TimmModel builds the trunk with
``num_classes=embed_dim`` (reference timm_model.py:52-67), so the timm
classifier head Linear(2*dims[-1], 512) IS the CLIP projection.

Architecture per timm fastvit.py / Apple ml-fastvit (timm is not installed
in this image; structure reconstructed from the published model family and
pinned by parameter-count agreement with the released sizes — MCi1 21.5M,
MCi2 35.7M. The torch replica in tests/test_fastvit.py encodes the same
contract in train-mode form):

* convolutional stem, 3 MobileOne blocks, GELU:
  3->d0 k3 s2, d0->d0 k3 s2 depthwise, d0->d0 k1 s1 (total stride 4)
* 4 stages; token mixers (repmixer, repmixer, repmixer, attention);
  between stages a PatchEmbed downsample: reparam large-kernel 7x7 s2
  grouped conv (+SE entering stages 2/3) + MobileOne 1x1; ConvFFN
  everywhere = depthwise 7x7 + 1x1 expand (ratio 3) + GELU + 1x1 project
* stage 4 is preceded by RepCPE (reparam depthwise 7x7 conditional
  positional encoding) and uses 32-dim-head attention with a BatchNorm
  pre-norm
* final MobileOne 3x3 grouped expansion to 2*dims[-1] with SE, global avg
  pool, head Linear -> embed_dim

Shapes: mci1 layers (4,12,20,4) dims (64,128,256,512); mci2 layers
(4,12,24,4) dims (80,160,320,640); both mlp_ratio 3, image_size 256.

Design choice: the tower is built in its REPARAMETERIZED inference
form — every train-time branch ensemble (MobileOne kxk+scale+skip BNs,
RepMixer mixer-norm difference, RepCPE identity, large-kernel small-kernel
sum, attention pre-BN, layer scales) is collapsed at convert time into
plain conv+bias / dense weights, so the JAX graph is pure fused
conv->SE->GELU chains with no batch_stats anywhere (same rationale as
resnet.py FrozenBatchNorm and mci_vit.py stem folding: the reference only
runs these towers frozen or converted). The converter implements the
complete RepVGG-style reparameterization math from the train-mode timm
checkpoint layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

from .layers import exact_gelu

Dtype = Any

SE_RD_RATIO = 0.0625  # SqueezeExcite reduction (rd_divisor=1: exact int())


@dataclasses.dataclass(frozen=True)
class FastViTConfig:
    image_size: int = 256
    layers: Tuple[int, ...] = (4, 12, 20, 4)
    dims: Tuple[int, ...] = (64, 128, 256, 512)
    mlp_ratio: float = 3.0
    # token mixer per stage: 'repmixer' | 'attention'
    token_mixers: Tuple[str, ...] = ("repmixer",) * 3 + ("attention",)
    se_downsamples: Tuple[bool, ...] = (False, False, True, True)
    pos_embed_stages: Tuple[int, ...] = (3,)  # RepCPE before these stages
    attn_head_dim: int = 32
    cls_ratio: float = 2.0  # final conv expansion
    embed_dim: int = 512

    @property
    def final_dim(self) -> int:
        return int(self.dims[-1] * self.cls_ratio)


MCI_FASTVIT_SHAPES: Dict[str, FastViTConfig] = {
    "fastvit_mci0": FastViTConfig(layers=(2, 6, 10, 2)),
    "fastvit_mci1": FastViTConfig(layers=(4, 12, 20, 4)),
    "fastvit_mci2": FastViTConfig(
        layers=(4, 12, 24, 4), dims=(80, 160, 320, 640)
    ),
}


class SqueezeExcite(nn.Module):
    """timm SqueezeExcite (rd_ratio 1/16, rd_divisor 1, relu/sigmoid)."""

    dim: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:  # NHWC
        rd = max(1, int(self.dim * SE_RD_RATIO))
        s = jnp.mean(x, axis=(1, 2))
        s = nn.relu(nn.Dense(rd, dtype=self.dtype, name="fc1")(s))
        s = jax.nn.sigmoid(nn.Dense(self.dim, dtype=self.dtype,
                                    name="fc2")(s))
        return x * s[:, None, None, :]


class RepConv(nn.Module):
    """A reparameterized conv branch ensemble: conv+bias [+SE] [+GELU].

    Inference form of MobileOneBlock / ReparamLargeKernelConv / RepMixer /
    RepCPE — which of those it came from is a converter concern only.
    """

    features: int
    kernel: int
    stride: int = 1
    groups: int = 1
    use_se: bool = False
    use_act: bool = True
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        p = self.kernel // 2
        x = nn.Conv(
            self.features, (self.kernel, self.kernel),
            strides=(self.stride, self.stride), padding=[(p, p), (p, p)],
            feature_group_count=self.groups, use_bias=True,
            dtype=self.dtype, name="conv",
        )(x)
        if self.use_se:
            x = SqueezeExcite(self.features, dtype=self.dtype, name="se")(x)
        if self.use_act:
            x = exact_gelu(x)
        return x


class ConvFFN(nn.Module):
    """FastViT ConvFFN: depthwise 7x7 (BN folded) -> 1x1 -> GELU -> 1x1.

    The block's layer-scale gamma is folded into fc2 at convert time, so
    callers add the output to the residual directly.
    """

    dim: int
    hidden: int
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        h = nn.Conv(
            self.dim, (7, 7), padding=[(3, 3), (3, 3)],
            feature_group_count=self.dim, use_bias=True, dtype=self.dtype,
            name="conv",
        )(x)
        h = nn.Conv(self.hidden, (1, 1), use_bias=True, dtype=self.dtype,
                    name="fc1")(h)
        h = exact_gelu(h)
        h = nn.Conv(self.dim, (1, 1), use_bias=True, dtype=self.dtype,
                    name="fc2")(h)
        return h


class RepMixerBlock(nn.Module):
    """Inference RepMixer block: reparam depthwise 3x3 token mixer (the
    x + gamma*(mixer - norm) ensemble collapsed, identity included) followed
    by a residual ConvFFN."""

    dim: int
    mlp_ratio: float
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        x = RepConv(self.dim, 3, groups=self.dim, use_act=False,
                    dtype=self.dtype, name="mixer")(x)
        x = x + ConvFFN(self.dim, int(self.dim * self.mlp_ratio),
                        dtype=self.dtype, name="ffn")(x)
        return x


class AttentionBlock(nn.Module):
    """Inference FastViT attention block.

    The pre-attention BatchNorm2d is folded into the qkv projection and
    layer_scale_1 into the output projection; layer_scale_2 into ffn.fc2.
    Attention is plain MHA with 32-dim heads over the flattened 2D grid
    (64 tokens at 256px stage 4) — XLA-fused, no Pallas needed at this size.
    """

    dim: int
    mlp_ratio: float
    head_dim: int = 32
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, h, w, c = x.shape
        heads = c // self.head_dim
        t = x.reshape(b, h * w, c)
        qkv = nn.Dense(3 * c, use_bias=True, dtype=self.dtype,
                       name="qkv")(t)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        def split(a):
            return a.reshape(b, h * w, heads, self.head_dim).transpose(
                0, 2, 1, 3)

        q, k, v = split(q), split(k), split(v)
        logits = jnp.einsum("bhnd,bhmd->bhnm", q, k) * self.head_dim**-0.5
        probs = jax.nn.softmax(logits, axis=-1)
        o = jnp.einsum("bhnm,bhmd->bhnd", probs, v)
        o = o.transpose(0, 2, 1, 3).reshape(b, h * w, c)
        o = nn.Dense(c, use_bias=True, dtype=self.dtype, name="proj")(o)
        x = x + o.reshape(b, h, w, c)
        x = x + ConvFFN(self.dim, int(self.dim * self.mlp_ratio),
                        dtype=self.dtype, name="ffn")(x)
        return x


class FastViTTower(nn.Module):
    cfg: FastViTConfig
    dtype: Dtype = jnp.float32
    remat: bool = False

    @nn.compact
    def __call__(self, images: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """images [B, S, S, 3] -> (pooled [B, embed_dim], tokens [B, HW, C])
        — tokens are the final-conv spatial features (pre-pool), matching
        the (pooled, tokens) tower convention used by CLIP.encode_image."""
        cfg = self.cfg
        d0 = cfg.dims[0]
        x = images.astype(self.dtype)
        x = RepConv(d0, 3, stride=2, dtype=self.dtype, name="stem_0")(x)
        x = RepConv(d0, 3, stride=2, groups=d0, dtype=self.dtype,
                    name="stem_1")(x)
        x = RepConv(d0, 1, dtype=self.dtype, name="stem_2")(x)

        rep_block, attn_block = RepMixerBlock, AttentionBlock
        if self.remat:
            rep_block = nn.remat(RepMixerBlock)
            attn_block = nn.remat(AttentionBlock)
        prev = d0
        for si, (depth, dim) in enumerate(zip(cfg.layers, cfg.dims)):
            if si > 0:
                # PatchEmbed: reparam large-kernel 7x7 s2 grouped conv
                # (+SE per se_downsamples) + MobileOne 1x1, both GELU
                x = RepConv(dim, 7, stride=2, groups=prev,
                            use_se=cfg.se_downsamples[si], dtype=self.dtype,
                            name=f"down_{si}_lk")(x)
                x = RepConv(dim, 1, dtype=self.dtype,
                            name=f"down_{si}_pw")(x)
            if si in cfg.pos_embed_stages:
                # RepCPE (identity folded into the kernel at convert time)
                x = RepConv(dim, 7, groups=dim, use_act=False,
                            dtype=self.dtype, name=f"pos_emb_{si}")(x)
            for bi in range(depth):
                if cfg.token_mixers[si] == "attention":
                    x = attn_block(dim, cfg.mlp_ratio,
                                   head_dim=cfg.attn_head_dim,
                                   dtype=self.dtype,
                                   name=f"stage_{si}_block_{bi}")(x)
                else:
                    x = rep_block(dim, cfg.mlp_ratio, dtype=self.dtype,
                                  name=f"stage_{si}_block_{bi}")(x)
            prev = dim

        x = RepConv(cfg.final_dim, 3, groups=cfg.dims[-1], use_se=True,
                    dtype=self.dtype, name="final_conv")(x)
        b, hh, ww, c = x.shape
        tokens = x.reshape(b, hh * ww, c)
        pooled = jnp.mean(x, axis=(1, 2))  # timm global_pool='avg'
        pooled = nn.Dense(cfg.embed_dim, use_bias=True, dtype=self.dtype,
                          name="head")(pooled)
        return pooled, tokens


# ---------------------------------------------------------------------------
# Converter: train-mode timm fastvit checkpoint -> reparameterized params
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return np.asarray(getattr(t, "detach", lambda: t)().cpu()) \
        if hasattr(t, "detach") else np.asarray(t)


def _first(sd: Mapping[str, Any], *keys: str) -> Optional[str]:
    """First present key among alternative timm/apple spellings."""
    for k in keys:
        if k in sd:
            return k
    return None


def _fold_bn(w: np.ndarray, b: Optional[np.ndarray],
             sd: Mapping[str, Any], bn_prefix: str,
             eps: float = 1e-5) -> Tuple[np.ndarray, np.ndarray]:
    """Fold an inference-mode BatchNorm2d into the preceding conv.
    w is torch layout [O, I/g, kh, kw]."""
    gamma = _np(sd[bn_prefix + ".weight"])
    beta = _np(sd[bn_prefix + ".bias"])
    mean = _np(sd[bn_prefix + ".running_mean"])
    var = _np(sd[bn_prefix + ".running_var"])
    inv = gamma / np.sqrt(var + eps)
    wf = w * inv[:, None, None, None]
    b0 = b if b is not None else np.zeros(w.shape[0], w.dtype)
    return wf, (b0 - mean) * inv + beta


def _identity_kernel(out_chs: int, in_per_group: int,
                     k: int) -> np.ndarray:
    """RepVGG-style identity as a grouped conv kernel [O, I/g, k, k]."""
    w = np.zeros((out_chs, in_per_group, k, k), np.float32)
    c = k // 2
    for i in range(out_chs):
        w[i, i % in_per_group, c, c] = 1.0
    return w


def _pad_to(w: np.ndarray, k: int) -> np.ndarray:
    """Zero-pad a [O, I/g, ks, ks] kernel to k x k (centered)."""
    ks = w.shape[-1]
    if ks == k:
        return w
    p = (k - ks) // 2
    return np.pad(w, ((0, 0), (0, 0), (p, p), (p, p)))


def _mobileone(sd: Mapping[str, Any], pre: str, in_chs: int, out_chs: int,
               k: int, groups: int,
               stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reparameterize a train-mode MobileOneBlock: sum of the BN-folded
    kxk conv branch, the 1x1 scale branch (padded to kxk), and the
    identity-BN branch. Returns torch-layout kernel [O, I/g, k, k] + bias."""
    in_pg = in_chs // groups
    w = np.zeros((out_chs, in_pg, k, k), np.float32)
    b = np.zeros((out_chs,), np.float32)
    conv_key = _first(sd, f"{pre}.conv_kxk.0.conv.weight",
                      f"{pre}.rbr_conv.0.conv.weight")
    if conv_key is not None:
        bn_pre = conv_key.rsplit(".conv.weight", 1)[0] + ".bn"
        wf, bf = _fold_bn(_np(sd[conv_key]), None, sd, bn_pre)
        w += wf
        b += bf
    scale_key = _first(sd, f"{pre}.conv_scale.conv.weight",
                       f"{pre}.rbr_scale.conv.weight")
    if scale_key is not None:
        bn_pre = scale_key.rsplit(".conv.weight", 1)[0] + ".bn"
        wf, bf = _fold_bn(_np(sd[scale_key]), None, sd, bn_pre)
        w += _pad_to(wf, k)
        b += bf
    id_key = _first(sd, f"{pre}.identity.weight", f"{pre}.rbr_skip.weight")
    if id_key is not None and in_chs == out_chs and stride == 1:
        bn_pre = id_key.rsplit(".weight", 1)[0]
        wf, bf = _fold_bn(_identity_kernel(out_chs, in_pg, k), None, sd,
                          bn_pre)
        w += wf
        b += bf
    return w, b


def _se_params(sd: Mapping[str, Any], pre: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for ours, theirs in (("fc1", ("fc1", "reduce")),
                         ("fc2", ("fc2", "expand"))):
        key = _first(sd, *(f"{pre}.{t}.weight" for t in theirs))
        if key is None:
            raise KeyError(f"SE weights not found under {pre!r}")
        kw = _np(sd[key])
        out[ours] = {
            # 1x1 conv [O, I, 1, 1] -> dense [I, O]
            "kernel": kw.reshape(kw.shape[0], kw.shape[1]).T,
            "bias": _np(sd[key.rsplit(".weight", 1)[0] + ".bias"]),
        }
    return out


def _torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)  # [O, I/g, kh, kw] -> [kh, kw, I/g, O]


def _rep_conv(w: np.ndarray, b: np.ndarray,
              se: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "conv": {"kernel": _torch_conv_to_flax(w), "bias": b}
    }
    if se is not None:
        out["se"] = se
    return out


def _gamma(sd: Mapping[str, Any], pre: str) -> Optional[np.ndarray]:
    key = _first(sd, f"{pre}.gamma", f"{pre}.weight")
    return None if key is None else _np(sd[key]).reshape(-1)


def _conv_ffn(sd: Mapping[str, Any], pre: str,
              ls: Optional[np.ndarray]) -> Dict[str, Any]:
    """mlp.conv (dw 7x7 + BN) / fc1 / fc2 1x1 convs; layer scale folded
    into fc2."""
    w, b = _fold_bn(_np(sd[f"{pre}.conv.conv.weight"]), None, sd,
                    f"{pre}.conv.bn")
    fc1_w = _np(sd[f"{pre}.fc1.weight"])
    fc1_b = _np(sd[f"{pre}.fc1.bias"])
    fc2_w = _np(sd[f"{pre}.fc2.weight"])
    fc2_b = _np(sd[f"{pre}.fc2.bias"])
    if ls is not None:
        fc2_w = fc2_w * ls[:, None, None, None]
        fc2_b = fc2_b * ls
    return {
        "conv": {"kernel": _torch_conv_to_flax(w), "bias": b},
        "fc1": {"kernel": _torch_conv_to_flax(fc1_w), "bias": fc1_b},
        "fc2": {"kernel": _torch_conv_to_flax(fc2_w), "bias": fc2_b},
    }


def _repmixer(sd: Mapping[str, Any], pre: str,
              dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """timm RepMixer.reparameterize(): id + gamma*(mixer - norm)."""
    wm, bm = _mobileone(sd, f"{pre}.mixer", dim, dim, 3, dim, 1)
    wn, bn_ = _mobileone(sd, f"{pre}.norm", dim, dim, 3, dim, 1)
    ls = _gamma(sd, f"{pre}.layer_scale")
    if ls is None:
        ls = np.ones((dim,), np.float32)
    w = _identity_kernel(dim, 1, 3) + ls[:, None, None, None] * (wm - wn)
    b = ls * (bm - bn_)
    return w, b


def _rep_cpe(sd: Mapping[str, Any], pre: str,
             dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """RepCPE: depthwise conv (bias) + identity folded into the kernel."""
    key = _first(sd, f"{pre}.pos_enc.weight", f"{pre}.pe.weight",
                 f"{pre}.pe.0.weight")
    if key is None:
        raise KeyError(f"RepCPE conv not found under {pre!r}")
    w = _np(sd[key]) + _identity_kernel(dim, 1, 7)
    b = _np(sd[key.rsplit(".weight", 1)[0] + ".bias"])
    return w, b


def _large_kernel(sd: Mapping[str, Any], pre: str, use_se: bool
                  ) -> Tuple[np.ndarray, np.ndarray,
                             Optional[Dict[str, Any]]]:
    """ReparamLargeKernelConv: BN-folded 7x7 + center-padded BN-folded 3x3."""
    lk_key = _first(sd, f"{pre}.large_conv.conv.weight",
                    f"{pre}.lkb_origin.conv.weight")
    if lk_key is None:
        raise KeyError(f"large-kernel conv not found under {pre!r}")
    lk_pre = lk_key.rsplit(".conv.weight", 1)[0]
    w, b = _fold_bn(_np(sd[lk_key]), None, sd, lk_pre + ".bn")
    sm_key = _first(sd, f"{pre}.small_conv.conv.weight")
    if sm_key is not None:
        ws, bs = _fold_bn(_np(sd[sm_key]), None, sd,
                          f"{pre}.small_conv.bn")
        w = w + _pad_to(ws, w.shape[-1])
        b = b + bs
    se = _se_params(sd, f"{pre}.se") if use_se else None
    return w, b, se


def infer_fastvit_config(sd: Mapping[str, Any],
                         prefix: str = "visual.") -> FastViTConfig:
    """Recover the FastViTConfig from a train-mode checkpoint's shapes
    (stage depths/dims, mixers, SE placement, head dims). image_size is not
    recoverable from weights and keeps the MCI default (256)."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    stem_key = _first(sd, "trunk.stem.0.conv_kxk.0.conv.weight",
                      "trunk.stem.0.rbr_conv.0.conv.weight")
    if stem_key is None:
        raise KeyError("not a fastvit checkpoint (no trunk.stem.0 conv)")
    layers, dims, mixers, ses, pes = [], [], [], [], []
    si = 0
    while f"trunk.stages.{si}.blocks.0.mlp.fc1.weight" in sd:
        fc1 = _np(sd[f"trunk.stages.{si}.blocks.0.mlp.fc1.weight"])
        dims.append(fc1.shape[1])
        n = 0
        while f"trunk.stages.{si}.blocks.{n}.mlp.fc1.weight" in sd:
            n += 1
        layers.append(n)
        attn = (f"trunk.stages.{si}.blocks.0.token_mixer.qkv.weight" in sd)
        mixers.append("attention" if attn else "repmixer")
        ses.append(_first(
            sd, f"trunk.stages.{si}.downsample.proj.0.se.fc1.weight",
            f"trunk.stages.{si}.downsample.proj.0.se.reduce.weight",
        ) is not None)
        if _first(sd, f"trunk.stages.{si}.pos_emb.pos_enc.weight",
                  f"trunk.stages.{si}.pos_emb.pe.weight",
                  f"trunk.stages.{si}.pos_emb.pe.0.weight") is not None:
            pes.append(si)
        si += 1
    fc_key = _first(sd, "trunk.final_conv.conv_kxk.0.conv.weight",
                    "trunk.final_conv.rbr_conv.0.conv.weight")
    final_dim = _np(sd[fc_key]).shape[0]
    head_key = _first(sd, "trunk.head.fc.weight", "trunk.head.weight")
    mlp_ratio = _np(
        sd["trunk.stages.0.blocks.0.mlp.fc1.weight"]).shape[0] / dims[0]
    return FastViTConfig(
        layers=tuple(layers), dims=tuple(dims), mlp_ratio=mlp_ratio,
        token_mixers=tuple(mixers), se_downsamples=tuple(ses),
        pos_embed_stages=tuple(pes),
        cls_ratio=final_dim / dims[-1],
        embed_dim=_np(sd[head_key]).shape[0],
    )


def convert_fastvit_state_dict(
    sd: Mapping[str, Any], cfg: FastViTConfig, prefix: str = "visual."
) -> Dict[str, Any]:
    """open_clip MobileCLIP-S* checkpoint (``visual.trunk.*``, train-mode
    timm fastvit naming) -> FastViTTower params, fully reparameterized."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {}
    d0 = cfg.dims[0]
    stem_shapes = ((3, d0, 3, 1, 2), (d0, d0, 3, d0, 2), (d0, d0, 1, 1, 1))
    for i, (ci, co, k, g, s) in enumerate(stem_shapes):
        w, b = _mobileone(sd, f"trunk.stem.{i}", ci, co, k, g, s)
        params[f"stem_{i}"] = _rep_conv(w, b)

    for si, (depth, dim) in enumerate(zip(cfg.layers, cfg.dims)):
        spre = f"trunk.stages.{si}"
        if si > 0:
            w, b, se = _large_kernel(
                sd, f"{spre}.downsample.proj.0", cfg.se_downsamples[si])
            params[f"down_{si}_lk"] = _rep_conv(w, b, se)
            w, b = _mobileone(sd, f"{spre}.downsample.proj.1",
                              dim, dim, 1, 1, 1)
            params[f"down_{si}_pw"] = _rep_conv(w, b)
        if si in cfg.pos_embed_stages:
            w, b = _rep_cpe(sd, f"{spre}.pos_emb", dim)
            params[f"pos_emb_{si}"] = _rep_conv(w, b)
        for bi in range(depth):
            bpre = f"{spre}.blocks.{bi}"
            name = f"stage_{si}_block_{bi}"
            if cfg.token_mixers[si] == "attention":
                # fold the pre-attention BatchNorm2d into qkv
                gamma = _np(sd[f"{bpre}.norm.weight"])
                beta = _np(sd[f"{bpre}.norm.bias"])
                mean = _np(sd[f"{bpre}.norm.running_mean"])
                var = _np(sd[f"{bpre}.norm.running_var"])
                inv = gamma / np.sqrt(var + 1e-5)
                qkv_w = _np(sd[f"{bpre}.token_mixer.qkv.weight"])
                qkv_b_key = _first(sd, f"{bpre}.token_mixer.qkv.bias")
                qkv_b = (_np(sd[qkv_b_key]) if qkv_b_key is not None
                         else np.zeros(qkv_w.shape[0], np.float32))
                qkv_w2 = qkv_w * inv[None, :]
                qkv_b2 = qkv_b + qkv_w @ (beta - mean * inv)
                # fold layer_scale_1 into the output projection
                ls1 = _gamma(sd, f"{bpre}.layer_scale_1")
                proj_w = _np(sd[f"{bpre}.token_mixer.proj.weight"])
                proj_b = _np(sd[f"{bpre}.token_mixer.proj.bias"])
                if ls1 is not None:
                    proj_w = proj_w * ls1[:, None]
                    proj_b = proj_b * ls1
                ls2 = _gamma(sd, f"{bpre}.layer_scale_2")
                params[name] = {
                    "qkv": {"kernel": qkv_w2.T, "bias": qkv_b2},
                    "proj": {"kernel": proj_w.T, "bias": proj_b},
                    "ffn": _conv_ffn(sd, f"{bpre}.mlp", ls2),
                }
            else:
                w, b = _repmixer(sd, f"{bpre}.token_mixer", dim)
                ls = _gamma(sd, f"{bpre}.layer_scale")
                params[name] = {
                    "mixer": _rep_conv(w, b),
                    "ffn": _conv_ffn(sd, f"{bpre}.mlp", ls),
                }

    w, b = _mobileone(sd, "trunk.final_conv", cfg.dims[-1], cfg.final_dim,
                      3, cfg.dims[-1], 1)
    params["final_conv"] = _rep_conv(
        w, b, _se_params(sd, "trunk.final_conv.se"))
    head_key = _first(sd, "trunk.head.fc.weight", "trunk.head.weight")
    if head_key is None:
        raise KeyError("classifier head not found (trunk.head.fc)")
    params["head"] = {
        "kernel": _np(sd[head_key]).T,
        "bias": _np(sd[head_key.rsplit(".weight", 1)[0] + ".bias"]),
    }
    return params
