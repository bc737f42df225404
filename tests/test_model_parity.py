"""Golden parity: JAX CLIP vs the reference torch CLIP on converted weights.

Loads the reference open_clip model code from /root/reference at test time as
an oracle (never copied), builds a small CLIP with random weights, converts the
state_dict with core.torch_convert, and checks encode_image/encode_text agree.
"""

import importlib
import sys
import types

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from clip_embeds.core.config import CLIPConfig, TextConfig, VisionConfig
from clip_embeds.core.torch_convert import convert_clip_state_dict
from clip_embeds.models.clip import CLIP


@pytest.fixture(scope="module")
def ref_model_module():
    import importlib.machinery

    torch = pytest.importorskip("torch")
    if "ftfy" not in sys.modules:
        stub = types.ModuleType("ftfy")
        stub.fix_text = lambda t: t
        stub.__spec__ = importlib.machinery.ModuleSpec("ftfy", None)
        sys.modules["ftfy"] = stub
    if "torchvision" not in sys.modules:
        for name in ("torchvision", "torchvision.ops", "torchvision.ops.misc"):
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = mod
        sys.modules["torchvision.ops.misc"].FrozenBatchNorm2d = torch.nn.BatchNorm2d
    pkg = types.ModuleType("refoc")
    pkg.__path__ = ["/root/reference/open_clip/src/open_clip"]
    sys.modules.setdefault("refoc", pkg)
    try:
        return importlib.import_module("refoc.model")
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"reference model unavailable: {exc}")


SMALL_VISION = dict(image_size=32, patch_size=16, width=64, layers=2, head_width=32)
SMALL_TEXT = dict(context_length=16, vocab_size=512, width=64, heads=2, layers=2)


@pytest.mark.parametrize("quick_gelu", [False, True])
def test_clip_parity(ref_model_module, quick_gelu):
    import torch

    torch.manual_seed(0)
    ref = ref_model_module.CLIP(
        embed_dim=32,
        vision_cfg=dict(
            image_size=32, patch_size=16, width=64, layers=2, head_width=32
        ),
        text_cfg=dict(
            context_length=16, vocab_size=512, width=64, heads=2, layers=2
        ),
        quick_gelu=quick_gelu,
    )
    ref.eval()

    cfg = CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(**SMALL_VISION),
        text=TextConfig(**SMALL_TEXT),
        quick_gelu=quick_gelu,
    )
    model = CLIP(cfg, attn_impl="reference")
    params = convert_clip_state_dict(ref.state_dict())

    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    # random token ids with EOT at varying positions
    text = np.zeros((3, 16), dtype=np.int64)
    for i, length in enumerate([5, 9, 14]):
        text[i, 0] = 510
        text[i, 1:length] = rng.integers(1, 500, length - 1)
        text[i, length] = 511  # highest id -> argmax pool picks it

    with torch.no_grad():
        ref_img = ref.encode_image(torch.from_numpy(images).permute(0, 3, 1, 2))
        ref_txt = ref.encode_text(torch.from_numpy(text))

    out_img = model.apply(
        {"params": params}, jnp.asarray(images), method="encode_image"
    )
    out_txt = model.apply(
        {"params": params}, jnp.asarray(text.astype(np.int32)),
        method="encode_text",
    )

    np.testing.assert_allclose(
        np.asarray(out_img), ref_img.numpy(), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(out_txt), ref_txt.numpy(), rtol=1e-4, atol=1e-4
    )


def test_output_tokens_shapes():
    cfg = CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(**SMALL_VISION),
        text=TextConfig(**SMALL_TEXT),
    )
    import jax

    model = CLIP(cfg, attn_impl="reference")
    images = jnp.zeros((2, 32, 32, 3))
    text = jnp.zeros((2, 16), jnp.int32)
    variables = model.init(jax.random.PRNGKey(0), images, text)

    pooled, tokens = model.apply(
        variables, images, output_tokens=True, method="encode_image"
    )
    assert pooled.shape == (2, 32)
    assert tokens.shape == (2, 4, 64)  # 2x2 grid of patches

    pooled_t, tokens_t = model.apply(
        variables, text, output_tokens=True, method="encode_text"
    )
    assert pooled_t.shape == (2, 32)
    assert tokens_t.shape == (2, 16, 64)

    out = model.apply(variables, images, text)
    assert set(out) == {"logit_scale", "image_features", "text_features"}
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out["image_features"]), axis=-1), 1.0, rtol=1e-5
    )


def test_sincos_pos_embed_matches_reference():
    import importlib.util

    from clip_embeds.models.vit import sincos_2d_pos_embed

    spec = importlib.util.spec_from_file_location(
        "_ref_pe", "/root/reference/open_clip/src/open_clip/pos_embed.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = mod.get_2d_sincos_pos_embed(64, 5, cls_token=True)
    mine = np.asarray(sincos_2d_pos_embed(64, 5, cls_token=True))
    np.testing.assert_allclose(mine, ref, atol=1e-6)


@pytest.mark.slow
def test_scan_layers_matches_unrolled():
    import jax

    from clip_embeds.core.factory import create_model
    from clip_embeds.models.clip import CLIP, stack_clip_params

    model, params = create_model("test-tiny", attn_impl="reference")
    smodel = CLIP(model.cfg, attn_impl="reference", scan_layers=True)
    sparams = stack_clip_params(params)

    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((2, 32, 32, 3)), jnp.float32)
    texts = jnp.asarray(rng.integers(1, 49000, (2, 77)), jnp.int32)
    a = model.apply({"params": params}, images, texts)
    b = smodel.apply({"params": sparams}, images, texts)
    for key in ("image_features", "text_features"):
        np.testing.assert_allclose(
            np.asarray(b[key]), np.asarray(a[key]), rtol=2e-4, atol=2e-5
        )
