"""ImageReward (BLIP-1 + reward MLP) parity vs the reference's vendored
med.py BertModel as oracle (loaded from /root/reference with compat shims for
the installed transformers), plus a timm-style torch ViT replica."""

import importlib.machinery
import importlib.util
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.blip import (
    BlipConfig,
    BlipTextConfig,
    ImageReward,
    convert_image_reward_state_dict,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

MED = ("/root/reference/t2v_metrics/t2v_metrics/models/vqascore_models/"
       "lavis/models/med.py")


@pytest.fixture(scope="module")
def med_module():
    torch = pytest.importorskip("torch")
    # compat: newer transformers moved these helpers to pytorch_utils
    import transformers.modeling_utils as mu
    import transformers.pytorch_utils as pu

    for name in ("apply_chunking_to_forward",
                 "find_pruneable_heads_and_indices", "prune_linear_layer"):
        if not hasattr(mu, name):
            setattr(mu, name, getattr(pu, name))
    # synthesize the package context med.py's relative imports expect
    pkg = types.ModuleType("reflavis")
    pkg.__path__ = []
    models_pkg = types.ModuleType("reflavis.models")
    models_pkg.__path__ = []
    common_pkg = types.ModuleType("reflavis.common")
    common_pkg.__path__ = []
    utils_mod = types.ModuleType("reflavis.common.utils")
    utils_mod.get_abs_path = lambda p: p
    base_mod = types.ModuleType("reflavis.models.base_model")
    base_mod.BaseEncoder = torch.nn.Module
    for name, mod in [
        ("reflavis", pkg), ("reflavis.models", models_pkg),
        ("reflavis.common", common_pkg),
        ("reflavis.common.utils", utils_mod),
        ("reflavis.models.base_model", base_mod),
    ]:
        mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
        sys.modules.setdefault(name, mod)
    spec = importlib.util.spec_from_file_location("reflavis.models.med", MED)
    med = importlib.util.module_from_spec(spec)
    sys.modules["reflavis.models.med"] = med
    spec.loader.exec_module(med)
    return med


def _text_cfg():
    return BlipTextConfig(
        vocab_size=120, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, max_position_embeddings=64,
    )


@pytest.fixture(scope="module")
def torch_replica(med_module):
    torch = pytest.importorskip("torch")
    from transformers import BertConfig

    med_cfg = BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, is_decoder=False,
    )
    med_cfg.add_cross_attention = True
    med_cfg.encoder_width = 48   # vision width
    med_cfg.add_type_embeddings = False

    class ViT(torch.nn.Module):
        """timm-layout ViT (fused qkv bias) matching BlipVisionTower."""

        def __init__(self, dim=48, heads=2, depth=2, patch=16, img=32,
                     mlp=96):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Conv2d(3, dim, patch, patch)

            self.patch_embed = PE()
            self.cls_token = torch.nn.Parameter(torch.randn(1, 1, dim) * .02)
            n = (img // patch) ** 2 + 1
            self.pos_embed = torch.nn.Parameter(torch.randn(1, n, dim) * .02)

            class Block(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)

                    class A(torch.nn.Module):
                        def __init__(self):
                            super().__init__()
                            self.qkv = torch.nn.Linear(dim, dim * 3)
                            self.proj = torch.nn.Linear(dim, dim)

                        def forward(self, x):
                            b, n, d = x.shape
                            hd = d // heads
                            q, k, v = self.qkv(x).chunk(3, -1)

                            def sp(t):
                                return t.reshape(b, n, heads, hd).transpose(1, 2)

                            q, k, v = sp(q), sp(k), sp(v)
                            a = (q @ k.transpose(-2, -1)) * hd ** -0.5
                            o = (a.softmax(-1) @ v).transpose(1, 2)
                            return self.proj(o.reshape(b, n, d))

                    self.attn = A()
                    self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
                    self.mlp = torch.nn.Module()
                    self.mlp.fc1 = torch.nn.Linear(dim, mlp)
                    self.mlp.fc2 = torch.nn.Linear(mlp, dim)

                def forward(self, x):
                    x = x + self.attn(self.norm1(x))
                    h = torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x)))
                    return x + self.mlp.fc2(h)

            self.blocks = torch.nn.ModuleList([Block() for _ in range(depth)])
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)

        def forward(self, x):
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], 1)
            x = x + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            return self.norm(x)

    class Reward(torch.nn.Module):
        def __init__(self):
            super().__init__()

            class Blip(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.visual_encoder = ViT()
                    self.text_encoder = med_module.BertModel(
                        med_cfg, add_pooling_layer=False
                    )

            self.blip = Blip()
            self.mlp = torch.nn.Module()
            self.mlp.layers = torch.nn.Sequential(
                torch.nn.Linear(32, 1024), torch.nn.Dropout(0.0),
                torch.nn.Linear(1024, 128), torch.nn.Dropout(0.0),
                torch.nn.Linear(128, 64), torch.nn.Dropout(0.0),
                torch.nn.Linear(64, 16), torch.nn.Linear(16, 1),
            )

        def forward(self, pixels, ids, mask):
            img = self.blip.visual_encoder(pixels)
            img_atts = torch.ones(img.shape[:-1], dtype=torch.long)
            out = self.blip.text_encoder(
                ids, attention_mask=mask, encoder_hidden_states=img,
                encoder_attention_mask=img_atts, return_dict=True,
            )
            feats = out.last_hidden_state[:, 0, :]
            return self.mlp.layers(feats)[:, 0]

    torch.manual_seed(0)
    return Reward().eval()


def test_image_reward_parity(torch_replica):
    import torch

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 120, (2, 9)).astype(np.int64)
    mask = np.ones((2, 9), np.int64)
    mask[1, -3:] = 0

    with torch.no_grad():
        raw = torch_replica(
            torch.tensor(pixels).permute(0, 3, 1, 2), torch.tensor(ids),
            torch.tensor(mask),
        ).numpy()

    cfg = BlipConfig(
        vision=VisionConfig(image_size=32, patch_size=16, width=48, layers=2,
                            head_width=24, mlp_ratio=2.0),
        text=_text_cfg(),
    )
    model = ImageReward(cfg, attn_impl="reference")
    params = convert_image_reward_state_dict(
        {k: v for k, v in torch_replica.state_dict().items()}
    )
    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels),
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(mask.astype(bool)),
    ))
    ref = (raw - model.mean) / model.std
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
