"""timm plain-ViT tower (vit_medium_patch16_gap_256 layout) parity vs a
torch replica with timm module naming (timm absent in this image)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

from clip_embeds.models.timm_vit import (  # noqa: E402
    TimmViTConfig,
    TimmViTTower,
    convert_timm_vit_state_dict,
)


def tiny_cfg() -> TimmViTConfig:
    return TimmViTConfig(image_size=32, patch_size=16, width=48, depth=2,
                         heads=4, class_token=False, pool="avg",
                         fc_norm=True, embed_dim=24)


@pytest.fixture(scope="module")
def torch_gap_vit():
    torch = pytest.importorskip("torch")

    class Attn(torch.nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.heads = heads
            self.qkv = torch.nn.Linear(dim, 3 * dim, bias=True)
            self.proj = torch.nn.Linear(dim, dim)

        def forward(self, x):
            b, n, d = x.shape
            hd = d // self.heads
            q, k, v = self.qkv(x).chunk(3, -1)

            def split(t):
                return t.reshape(b, n, self.heads, hd).transpose(1, 2)

            q, k, v = split(q), split(k), split(v)
            a = ((q @ k.transpose(-2, -1)) * hd ** -0.5).softmax(-1)
            return self.proj((a @ v).transpose(1, 2).reshape(b, n, d))

    class Block(torch.nn.Module):
        def __init__(self, dim, heads, hidden):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.attn = Attn(dim, heads)
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(dim, hidden)
            self.mlp.fc2 = torch.nn.Linear(hidden, dim)

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            h = torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x)))
            return x + self.mlp.fc2(h)

    class Trunk(torch.nn.Module):
        def __init__(self, dim=48, heads=4, depth=2, patch=16, img=32):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Conv2d(3, dim, patch, patch)

            self.patch_embed = PE()
            g = img // patch
            self.pos_embed = torch.nn.Parameter(
                torch.randn(1, g * g, dim) * 0.02)
            self.blocks = torch.nn.ModuleList(
                [Block(dim, heads, 4 * dim) for _ in range(depth)])
            self.fc_norm = torch.nn.LayerNorm(dim, eps=1e-6)

        def forward(self, x):
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = x + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            return self.fc_norm(x.mean(dim=1))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = Trunk()

            class Head(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Linear(48, 24, bias=False)

            self.head = Head()

        def forward(self, x):
            return self.head.proj(self.trunk(x))

    torch.manual_seed(0)
    return Model().eval()


def test_timm_gap_vit_parity(torch_gap_vit):
    import torch

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_gap_vit(torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    model = TimmViTTower(tiny_cfg())
    params = convert_timm_vit_state_dict(
        {"visual." + k: v for k, v in torch_gap_vit.state_dict().items()}
    )
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)
    assert tokens.shape == (2, 4, 48)


def test_timm_vit_registry_native():
    from clip_embeds.core.config import get_model_config
    from clip_embeds.core.openclip_registry import classify_model

    backend, detail = classify_model("vit_medium_patch16_gap_256")
    assert backend == "clip", detail
    cfg = get_model_config("vit_medium_patch16_gap_256")
    assert cfg.vision.tower == "timm-vit"
    assert cfg.vision.width == 512 and cfg.vision.image_size == 256
    assert cfg.vision.pool_type == "avg" and cfg.vision.final_ln_after_pool

    from clip_embeds.core.config import CLIPConfig, TextConfig, VisionConfig
    from clip_embeds.models.clip import CLIP

    clip_cfg = CLIPConfig(
        embed_dim=24,
        vision=VisionConfig(tower="timm-vit", image_size=32, patch_size=16,
                            width=48, layers=2, head_width=12,
                            pool_type="avg", final_ln_after_pool=True),
        text=TextConfig(context_length=12, vocab_size=64, width=32, heads=2,
                        layers=2),
    )
    model = CLIP(clip_cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        jnp.zeros((1, 12), jnp.int32))["params"]
    out = model.apply({"params": params}, jnp.zeros((1, 32, 32, 3)),
                      jnp.zeros((1, 12), jnp.int32))
    assert out["image_features"].shape == (1, 24)
