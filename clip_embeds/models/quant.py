"""Int8 quantized inference path for Dense layers.

XLA lowers the s8 x s8 -> s32 dot_general to a cuBLAS int8 GEMM on an
H100 (PERF.md has its rate beside bf16). QuantDense stores per-output-channel int8 weights and quantizes
activations dynamically per tensor; accumulation is int32 with fp32 rescale.
This is a serving-path option (off by default) — the reference stack has no
quantized path at all, so this is pure headroom over its fp16 deployment.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np
from .._vendor.flax import linen as nn

Dtype = Any


def _lora_delta(module: nn.Module, x: jax.Array, features: int,
                rank: int, alpha: float) -> jax.Array:
    """Unmaterialized LoRA side-path: ``scale * (x @ A) @ B`` as two rank-r
    matmuls, read from the separate flax ``lora`` variable collection so the
    base kernel (fp OR int8) is never rewritten. This is what lets the
    reference's QLoRA-shaped recipe (frozen trunk + LoRA adapters,
    VLM2Vec/src/model.py:97-144) train without a second weight tree:
    ``materialize`` builds a second full set of targeted kernels
    (base+delta, ~2x trunk memory),
    while this path adds only the [in,r]+[r,out] fp32 adapters.

    Adapters come from ``models.lora.to_collection(init_lora(...))`` passed
    as ``model.apply({'params': ..., 'lora': ...})``. A kernel with no
    entry in the collection is simply not adapted (delta 0) — the adapter
    TREE defines the target set (e.g. lora_target_modules subsets), the
    module's lora_rank only enables the side-path. Returns None when this
    kernel has no adapter (including at model.init, where the collection
    doesn't exist yet)."""
    if not module.has_variable("lora", "a"):
        return None
    a = module.variable(
        "lora", "a", lambda: jnp.zeros((x.shape[-1], rank), jnp.float32))
    b = module.variable(
        "lora", "b", lambda: jnp.zeros((rank, features), jnp.float32))
    xf = x.astype(jnp.float32)
    return ((xf @ a.value) @ b.value) * (alpha / rank)


class LoraDense(nn.Dense):
    """nn.Dense plus an unmaterialized LoRA side-path (same param layout as
    Dense — the adapters live in the 'lora' collection, not 'params')."""

    lora_rank: int = 0
    lora_alpha: float = 16.0

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        y = super().__call__(x)
        if self.lora_rank > 0:
            delta = _lora_delta(self, x, self.features, self.lora_rank,
                                self.lora_alpha)
            if delta is not None:
                y = (y.astype(jnp.float32) + delta).astype(self.dtype)
        return y


def quantize_weight(kernel: np.ndarray):
    """fp kernel [in, out] -> (int8 kernel, fp32 per-out-channel scale)."""
    kernel = np.asarray(kernel, np.float32)
    scale = np.abs(kernel).max(axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.rint(kernel / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


class QuantDense(nn.Module):
    """Drop-in Dense with int8 weights + int8 activations.

    mode='dynamic': per-tensor activation scale computed on the fly (and sown
    into the 'quant_obs' collection for calibration).
    mode='static': uses the calibrated 'act_scale' param — no reduction pass
    on the hot path, which is where the int8 speedup actually materializes.
    """

    features: int
    use_bias: bool = True
    dtype: Dtype = jnp.float32
    mode: str = "dynamic"
    lora_rank: int = 0       # unmaterialized LoRA over the frozen int8 base
    lora_alpha: float = 16.0

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        in_features = x.shape[-1]
        kernel_q = self.param(
            "kernel_q",
            lambda key, shape: jnp.zeros(shape, jnp.int8),
            (in_features, self.features),
        )
        scale = self.param(
            "scale", nn.initializers.ones, (self.features,)
        )
        x32 = x.astype(jnp.float32)
        if self.mode == "static":
            act_scale = self.param(
                "act_scale", nn.initializers.ones, ()
            )
            a_scale = jnp.maximum(act_scale, 1e-8)
        else:
            observed = jnp.max(jnp.abs(x32))
            self.sow("quant_obs", "act_max", observed,
                     init_fn=lambda: jnp.zeros(()),
                     reduce_fn=jnp.maximum)
            a_scale = jnp.maximum(observed / 127.0, 1e-8)
        x_q = jnp.clip(jnp.round(x32 / a_scale), -127, 127).astype(jnp.int8)
        acc = jax.lax.dot_general(
            x_q, kernel_q,
            (((x.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        y = acc.astype(jnp.float32) * (a_scale * scale)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.features,))
            y = y + bias
        if self.lora_rank > 0:
            delta = _lora_delta(self, x, self.features, self.lora_rank,
                                self.lora_alpha)
            if delta is not None:
                y = y + delta
        return y.astype(self.dtype)


def dense(quant, features: int, use_bias: bool = True, dtype=jnp.float32,
          name: Optional[str] = None, lora_rank: int = 0,
          lora_alpha: float = 16.0):
    """Dense factory: quant in (False/"", True/'dynamic', 'static');
    lora_rank > 0 adds the unmaterialized LoRA side-path (either base)."""
    if quant:
        mode = "static" if quant == "static" else "dynamic"
        return QuantDense(features, use_bias=use_bias, dtype=dtype, mode=mode,
                          lora_rank=lora_rank, lora_alpha=lora_alpha,
                          name=name)
    if lora_rank > 0:
        return LoraDense(features, use_bias=use_bias, dtype=dtype,
                         lora_rank=lora_rank, lora_alpha=lora_alpha,
                         name=name)
    return nn.Dense(features, use_bias=use_bias, dtype=dtype, name=name)


QUANT_LAYER_NAMES = ("in_proj", "out_proj", "c_fc", "c_proj", "fc1", "fc2")
# Llama trunk projections (models/llama.py quant='dynamic'/'static'):
# attention q/k/v/o + SwiGLU gate/up/down. Embeddings, RMSNorms and the
# lm_head stay fp (the vocab matmul runs once per position; accuracy-critical)
LLAMA_QUANT_LAYER_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj",
)
# T5 encoder/decoder projections (models/t5.py quant='dynamic'/'static'):
# self/cross attention q/k/v/o + gated-GELU wi_0/wi_1/wo (plus the 'wi' of
# the relu variant). Embeddings, T5LayerNorms, relative-position bias and
# the lm_head stay fp.
T5_QUANT_LAYER_NAMES = ("q", "k", "v", "o", "wi_0", "wi_1", "wi", "wo")


def quantize_dense_tree(params: Any, layer_names=QUANT_LAYER_NAMES) -> Any:
    """Replace the Dense subtrees that QuantDense owns (attention and MLP
    projections — the compute-bound matmuls) with the QuantDense layout
    {'kernel_q', 'scale' [, 'bias']}. Embeddings, layer norms, patchify and
    head projections stay in floating point."""

    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        if name in layer_names and "kernel" in node:
            q, scale = quantize_weight(np.asarray(node["kernel"]))
            out = {"kernel_q": q, "scale": scale}
            if "bias" in node:
                out["bias"] = np.asarray(node["bias"], np.float32)
            return out
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params)


def quantize_tree_on_device(params: Any, layer_names=QUANT_LAYER_NAMES,
                            free_source: bool = False) -> Any:
    """quantize_dense_tree computed ON DEVICE (per-leaf jitted abs-max
    quantization) — for multi-GB trees that were built on device and would
    be slow to round-trip through the host (e.g. a 13.5 GB Llama-7B).
    ``free_source=True`` deletes each source kernel buffer right after its
    int8 replacement materializes, so peak memory stays ~source size + one
    leaf."""
    import jax

    @jax.jit
    def qleaf(kernel):
        # reduce the in-features axis (-2): correct for both plain [in, out]
        # kernels and scan-stacked [L, in, out] kernels (per-layer scales)
        k32 = kernel.astype(jnp.float32)
        scale = jnp.abs(k32).max(axis=-2, keepdims=True) / 127.0
        scale = jnp.where(scale == 0, 1.0, scale)
        q = jnp.clip(jnp.round(k32 / scale), -127, 127).astype(jnp.int8)
        return q, jnp.squeeze(scale, axis=-2).astype(jnp.float32)

    def walk(node, name=""):
        if not isinstance(node, dict):
            return node
        if name in layer_names and "kernel" in node:
            q, scale = qleaf(node["kernel"])
            jax.block_until_ready(q)
            out = {"kernel_q": q, "scale": scale}
            if "bias" in node:
                out["bias"] = node["bias"]
            if free_source:
                node["kernel"].delete()
            return out
        return {k: walk(v, k) for k, v in node.items()}

    return walk(params)


def quantize_clip_t5_trunk(params: Any) -> Any:
    """Quantize ONLY the T5 encoder+decoder of a CLIPT5 param tree (vision
    tower, projector, shared embedding, norms, lm_head stay fp). Pair with
    ``CLIPT5(..., quant_t5='dynamic'|'static')``. flan-t5-xl drops from
    ~5.7 GB bf16 to ~2.9 GB int8; flan-t5-xxl (the reference's DEFAULT
    VQAScore backbone, 11B) from ~22 GB to ~11.2 GB."""
    out = dict(params)
    out["t5"] = quantize_dense_tree(params["t5"], T5_QUANT_LAYER_NAMES)
    return out


def quantize_llava_trunk(params: Any) -> Any:
    """Quantize ONLY the Llama trunk of a Llava param tree (vision tower,
    projector, embeddings, norms, lm_head stay fp). Pair with
    ``Llava(..., quant_llm='dynamic'|'static')``. The 7B trunk drops from
    ~13.5 GB bf16 to ~6.9 GB int8."""
    out = dict(params)
    lm = dict(params["language_model"])
    lm["model"] = quantize_dense_tree(lm["model"], LLAMA_QUANT_LAYER_NAMES)
    out["language_model"] = lm
    return out


def inject_act_scales(params: Any, obs: Any) -> Any:
    """Bake observed per-layer activation maxima ('quant_obs' collection)
    into 'act_scale' params for static-mode QuantDense."""

    def inject(p, o):
        if not isinstance(p, dict):
            return p
        out = {}
        for k, v in p.items():
            if isinstance(v, dict) and "kernel_q" in v and k in o:
                act_max = np.asarray(o[k]["act_max"]).max()
                out[k] = dict(v, act_scale=np.float32(max(act_max / 127.0, 1e-8)))
            elif isinstance(v, dict):
                out[k] = inject(v, o.get(k, {}) if isinstance(o, dict) else {})
            else:
                out[k] = v
        return out

    return inject(params, obs)


def calibrate_act_scales(model, params: Any, batches, apply_kwargs=None) -> Any:
    """Run a dynamic-mode quant model over batches, collect per-layer
    activation maxima, and bake 'act_scale' params for static mode."""
    import jax

    apply_kwargs = apply_kwargs or {}
    maxima = None
    for batch in batches:
        _, state = model.apply(
            {"params": params}, *batch, mutable=["quant_obs"], **apply_kwargs
        )
        obs = state["quant_obs"]
        if maxima is None:
            maxima = obs
        else:
            maxima = jax.tree.map(jnp.maximum, maxima, obs)

    return inject_act_scales(params, jax.device_get(maxima))
