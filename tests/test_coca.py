"""CoCa parity vs the reference torch CoCa + loss sanity."""

import importlib
import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.config import TextConfig, VisionConfig
from clip_embeds.core.torch_convert import convert_coca_state_dict
from clip_embeds.losses.coca import coca_loss
from clip_embeds.models.coca import CoCa, CoCaConfig, MultimodalConfig

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def ref_coca():
    torch = pytest.importorskip("torch")
    import importlib.machinery

    for name in ("ftfy",):
        if name not in sys.modules:
            stub = types.ModuleType(name)
            stub.fix_text = lambda t: t
            stub.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = stub
    if "torchvision" not in sys.modules:
        for name in ("torchvision", "torchvision.ops", "torchvision.ops.misc"):
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = mod
        sys.modules["torchvision.ops.misc"].FrozenBatchNorm2d = torch.nn.BatchNorm2d
    pkg = types.ModuleType("refoc")
    pkg.__path__ = ["/root/reference/open_clip/src/open_clip"]
    sys.modules.setdefault("refoc", pkg)
    torch.manual_seed(0)
    mod = importlib.import_module("refoc.coca_model")
    # The committed reference has a bug: TextTransformer.forward (cls path,
    # transformer.py:1084) passes text_global_pool's *tuple* into ln_final.
    # Patch the helper to return only the pooled tensor for that call pattern
    # (the intended semantics; upstream open_clip later fixed it the same way).
    ref_tf = importlib.import_module("refoc.transformer")
    orig_pool = ref_tf.text_global_pool

    def fixed_pool(x, text=None, pool_type="argmax"):
        if text is None and pool_type == "last":
            return x[:, -1]
        return orig_pool(x, text, pool_type)

    ref_tf.text_global_pool = fixed_pool
    model = mod.CoCa(
        embed_dim=32,
        multimodal_cfg=dict(context_length=15, vocab_size=128, width=32,
                            heads=2, layers=2),
        text_cfg=dict(context_length=15, vocab_size=128, width=32, heads=2,
                      layers=2, embed_cls=True, output_tokens=True),
        vision_cfg=dict(image_size=32, patch_size=16, width=64, layers=2,
                        head_width=32, attentional_pool=True,
                        attn_pooler_heads=2, attn_pooler_queries=8,
                        output_tokens=True),
    )
    # The reference MultimodalTransformer leaves text_projection as
    # torch.empty (its init_parameters references a nonexistent
    # self.transformer and is never called) — initialize it so the fixture is
    # deterministic instead of reading uninitialized memory.
    with torch.no_grad():
        model.text_decoder.text_projection.normal_(0, 0.02)
    model.eval()
    return model


def _jax_model():
    cfg = CoCaConfig(
        embed_dim=32,
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
        text=TextConfig(context_length=15, vocab_size=128, width=32, heads=2,
                        layers=2),
        multimodal=MultimodalConfig(context_length=15, width=32, heads=2,
                                    layers=2),
        attn_pooler_queries=8,
        attn_pooler_heads=2,
    )
    return CoCa(cfg, attn_impl="reference")


def test_coca_parity(ref_coca):
    import torch

    model = _jax_model()
    params = convert_coca_state_dict(ref_coca.state_dict())

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    text = np.zeros((2, 15), np.int64)
    for i, length in enumerate([8, 12]):
        text[i, 0] = 126
        text[i, 1:length] = rng.integers(1, 120, length - 1)
        text[i, length] = 127

    with torch.no_grad():
        ref_out = ref_coca(
            torch.from_numpy(images.transpose(0, 3, 1, 2)),
            torch.from_numpy(text),
        )

    out = model.apply(
        {"params": params}, jnp.asarray(images),
        jnp.asarray(text.astype(np.int32)),
    )
    np.testing.assert_allclose(
        np.asarray(out["image_features"]),
        ref_out["image_features"].numpy(), rtol=3e-4, atol=3e-4,
    )
    np.testing.assert_allclose(
        np.asarray(out["text_features"]),
        ref_out["text_features"].numpy(), rtol=3e-4, atol=3e-4,
    )
    assert out["logits"].shape == tuple(ref_out["logits"].shape)
    np.testing.assert_allclose(
        np.asarray(out["logits"]), ref_out["logits"].numpy(),
        rtol=2e-3, atol=1e-3,
    )
    np.testing.assert_array_equal(
        np.asarray(out["labels"]), ref_out["labels"].numpy()
    )


def test_coca_loss(ref_coca):
    model = _jax_model()
    params = convert_coca_state_dict(ref_coca.state_dict())
    rng = np.random.default_rng(1)
    images = jnp.asarray(rng.standard_normal((2, 32, 32, 3)), jnp.float32)
    text = jnp.asarray(rng.integers(1, 120, (2, 15)), jnp.int32)
    out = model.apply({"params": params}, images, text)
    losses = coca_loss(out)
    assert np.isfinite(float(losses["loss"]))
    assert float(losses["caption_loss"]) > 0
