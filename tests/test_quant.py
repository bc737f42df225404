"""Int8 quantized inference path tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.factory import create_model
from clip_embeds.models.clip import CLIP
from clip_embeds.models.quant import quantize_dense_tree, quantize_weight


def test_quantize_weight_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    q, scale = quantize_weight(w)
    assert q.dtype == np.int8
    back = q.astype(np.float32) * scale
    assert np.abs(back - w).max() < np.abs(w).max() / 100


def test_quantized_clip_close_to_fp():
    model, params = create_model("test-tiny", attn_impl="reference")
    qmodel = CLIP(model.cfg, attn_impl="reference", quant=True)
    qparams = quantize_dense_tree(jax.device_get(params))

    rng = np.random.default_rng(1)
    images = jnp.asarray(rng.standard_normal((4, 32, 32, 3)), jnp.float32)
    texts = jnp.asarray(rng.integers(1, 49000, (4, 77)), jnp.int32)

    out_fp = model.apply({"params": params}, images, texts)
    out_q = qmodel.apply({"params": qparams}, images, texts)

    for key in ("image_features", "text_features"):
        a = np.asarray(out_fp[key])
        b = np.asarray(out_q[key])
        cos = (a * b).sum(-1)  # both L2-normalized
        assert cos.min() > 0.98, (key, cos)


def test_quantized_params_are_int8():
    _, params = create_model("test-tiny", attn_impl="reference")
    qparams = quantize_dense_tree(jax.device_get(params))
    blk = qparams["visual"]["transformer"]["resblocks_0"]
    assert blk["attn"]["in_proj"]["kernel_q"].dtype == np.int8
    assert "kernel" not in blk["attn"]["in_proj"]
    assert blk["mlp"]["c_fc"]["scale"].shape == (256,)
    # untouched trees keep fp kernels
    assert "kernel" in qparams["visual"]["patch_embed"]


def test_static_calibration_matches_dynamic():
    from clip_embeds.models.quant import calibrate_act_scales

    model, params = create_model("test-tiny", attn_impl="reference")
    qdyn = CLIP(model.cfg, attn_impl="reference", quant="dynamic")
    qparams = quantize_dense_tree(jax.device_get(params))

    rng = np.random.default_rng(2)
    images = jnp.asarray(rng.standard_normal((4, 32, 32, 3)), jnp.float32)
    texts = jnp.asarray(rng.integers(1, 49000, (4, 77)), jnp.int32)

    sparams = calibrate_act_scales(qdyn, qparams, [(images, texts)])
    qstat = CLIP(model.cfg, attn_impl="reference", quant="static")

    out_d = qdyn.apply({"params": qparams}, images, texts)
    out_s = qstat.apply({"params": sparams}, images, texts)
    for key in ("image_features", "text_features"):
        cos = (np.asarray(out_d[key]) * np.asarray(out_s[key])).sum(-1)
        assert cos.min() > 0.999

    # static params carry calibrated scalars
    blk = sparams["visual"]["transformer"]["resblocks_0"]
    assert float(blk["attn"]["in_proj"]["act_scale"]) > 0


def test_validate_int8_cli(tmp_path):
    """Cross-distribution int8-vs-bf16 validation CLI on the tiny model."""
    from clip_embeds.cli.validate_int8 import main

    out = tmp_path / "report.json"
    report = main([
        "--model", "test-tiny", "--batch-size", "8",
        "--distributions", "noise,smooth",
        "--min-cos", "0.95", "--min-agreement", "0.5",
        "--out", str(out),
    ])
    assert len(report["pairs"]) == 4
    for row in report["pairs"]:
        assert row["cos_mean"] > 0.95
    assert report["pass"] is True
    import json

    assert json.load(open(out))["pass"] is True


def test_quantize_tree_on_device_stacked_layout():
    """quantize_tree_on_device must be axis-correct for scan-stacked
    [L, in, out] kernels: stack-then-quantize == quantize-then-stack
    (the first probe quantized a stacked tree with an axis-0 reduction and
    produced mis-shaped scales that tripped flax's scan assertion)."""
    import jax
    import jax.numpy as jnp

    from clip_embeds.models.llama import stack_llama_params
    from clip_embeds.models.quant import (
        LLAMA_QUANT_LAYER_NAMES,
        quantize_dense_tree,
        quantize_tree_on_device,
    )

    rng = np.random.default_rng(0)
    unrolled = {"model": {
        "layers_0": {"self_attn": {"q_proj": {
            "kernel": rng.standard_normal((8, 16)).astype(np.float32)}}},
        "layers_1": {"self_attn": {"q_proj": {
            "kernel": rng.standard_normal((8, 16)).astype(np.float32)}}},
        "norm": {"weight": np.ones(8, np.float32)},
    }}
    a = stack_llama_params(
        {"model": quantize_dense_tree(unrolled["model"],
                                      LLAMA_QUANT_LAYER_NAMES)})
    b = dict(stack_llama_params(unrolled))
    b["model"] = quantize_tree_on_device(b["model"],
                                         LLAMA_QUANT_LAYER_NAMES)
    qa = a["model"]["blocks"]["self_attn"]["q_proj"]
    qb = b["model"]["blocks"]["self_attn"]["q_proj"]
    np.testing.assert_array_equal(np.asarray(qa["kernel_q"]),
                                  np.asarray(qb["kernel_q"]))
    np.testing.assert_allclose(np.asarray(qa["scale"]),
                               np.asarray(qb["scale"]), rtol=1e-6)
    assert qb["scale"].shape == (2, 16)
