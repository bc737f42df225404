"""ModifiedResNet parity vs the reference torch module."""

import importlib
import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.torch_convert import convert_modified_resnet_state_dict
from clip_embeds.models.resnet import ModifiedResNet

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def ref_resnet():
    torch = pytest.importorskip("torch")
    import importlib.machinery

    if "torchvision" not in sys.modules:
        for name in ("torchvision", "torchvision.ops", "torchvision.ops.misc"):
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = mod
        sys.modules["torchvision.ops.misc"].FrozenBatchNorm2d = torch.nn.BatchNorm2d
    pkg = types.ModuleType("refoc")
    pkg.__path__ = ["/root/reference/open_clip/src/open_clip"]
    sys.modules.setdefault("refoc", pkg)
    return importlib.import_module("refoc.modified_resnet")


def test_resnet_parity(ref_resnet):
    import torch

    torch.manual_seed(0)
    # tiny RN: layers [1,1,1,1], width 16, image 64 -> grid 2x2
    ref = ref_resnet.ModifiedResNet(
        layers=[1, 1, 1, 1], output_dim=32, heads=4, image_size=64, width=16
    )
    ref.eval()
    # randomize BN running stats so the test catches stat mapping errors
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.7, 1.3)

    params = convert_modified_resnet_state_dict(ref.state_dict(), prefix="")
    model = ModifiedResNet(
        layers=[1, 1, 1, 1], output_dim=32, heads=4, image_size=64, width=16
    )

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        expected = ref(torch.from_numpy(images.transpose(0, 3, 1, 2))).numpy()

    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    assert tokens.shape == (2, 4, 16 * 32)
    np.testing.assert_allclose(
        np.asarray(pooled), expected, rtol=2e-4, atol=2e-4
    )


def test_full_clip_rn_parity(ref_resnet):
    """Full CLIP with a tiny ResNet tower vs the reference CLIP class."""
    import importlib

    import torch

    refm = importlib.import_module("refoc.model")
    torch.manual_seed(1)
    ref = refm.CLIP(
        embed_dim=32,
        vision_cfg=dict(layers=[1, 1, 1, 1], width=16, image_size=64),
        text_cfg=dict(context_length=16, vocab_size=128, width=64, heads=2,
                      layers=2),
    )
    ref.eval()
    for m in ref.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.7, 1.3)

    from clip_embeds.core.config import CLIPConfig, TextConfig, VisionConfig
    from clip_embeds.core.torch_convert import convert_clip_state_dict
    from clip_embeds.models.clip import CLIP

    cfg = CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(tower="resnet", image_size=64, width=16,
                            resnet_layers=(1, 1, 1, 1)),
        text=TextConfig(context_length=16, vocab_size=128, width=64, heads=2,
                        layers=2),
    )
    model = CLIP(cfg, attn_impl="reference")
    params = convert_clip_state_dict(ref.state_dict())

    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        expected = ref.encode_image(
            torch.from_numpy(images.transpose(0, 3, 1, 2))
        ).numpy()
    got = model.apply(
        {"params": params}, jnp.asarray(images), method="encode_image"
    )
    np.testing.assert_allclose(np.asarray(got), expected, rtol=3e-4, atol=3e-4)
