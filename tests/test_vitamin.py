"""ViTamin tower parity vs a torch replica of the timm vitamin.py layout
(timm is not installed in this image; the replica follows the published
architecture: MbConvLN stages -> StridedConv -> GeGLU ViT stage -> avg pool
-> fc_norm -> linear proj, with timm's module/key naming so the converter
is exercised end to end)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

from clip_embeds.models.vitamin import (  # noqa: E402
    VitaminConfig,
    VitaminTower,
    convert_vitamin_trunk_state_dict,
    vitamin_config,
)


def tiny_cfg() -> VitaminConfig:
    return VitaminConfig(
        image_size=64, mbconv_dims=(16, 24), mbconv_depths=(2, 2),
        width=48, depth=2, heads=4, embed_dim=32,
    )


@pytest.fixture(scope="module")
def torch_vitamin():
    torch = pytest.importorskip("torch")

    class Stem(torch.nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.conv1 = torch.nn.Conv2d(cin, cout, 3, 2, 1)
            self.norm1 = torch.nn.LayerNorm(cout, eps=1e-6)
            self.conv2 = torch.nn.Conv2d(cout, cout, 3, 1, 1)

        def forward(self, x):
            x = self.conv1(x)
            x = self.norm1(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = torch.nn.functional.gelu(x)
            return self.conv2(x)

    class Downsample2d(torch.nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.pool = torch.nn.AvgPool2d(3, 2, 1, count_include_pad=False)
            # timm: expand conv only when the dims change, else Identity
            self.expand = (torch.nn.Conv2d(cin, cout, 1)
                           if cin != cout else torch.nn.Identity())

        def forward(self, x):
            return self.expand(self.pool(x))

    class MbConvLNBlock(torch.nn.Module):
        def __init__(self, cin, cout, stride):
            super().__init__()
            mid = int(cout * 4.0)
            if stride == 2:
                self.shortcut = Downsample2d(cin, cout)
            elif cin != cout:
                self.shortcut = torch.nn.Conv2d(cin, cout, 1)
            else:
                self.shortcut = torch.nn.Identity()
            self.pre_norm = torch.nn.LayerNorm(cin, eps=1e-6)
            self.conv1_1x1 = torch.nn.Conv2d(cin, mid, 1)
            self.conv2_kxk = torch.nn.Conv2d(mid, mid, 3, stride, 1,
                                             groups=mid)
            self.conv3_1x1 = torch.nn.Conv2d(mid, cout, 1)

        def forward(self, x):
            shortcut = self.shortcut(x)
            x = self.pre_norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            x = torch.nn.functional.gelu(self.conv1_1x1(x))
            x = torch.nn.functional.gelu(self.conv2_kxk(x))
            return self.conv3_1x1(x) + shortcut

    class StridedConv(torch.nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.proj = torch.nn.Conv2d(cin, cout, 3, 2, 1)
            self.norm = torch.nn.LayerNorm(cin, eps=1e-6)

        def forward(self, x):
            x = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            return self.proj(x)

    class Attn(torch.nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.heads = heads
            self.qkv = torch.nn.Linear(dim, dim * 3, bias=True)
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

    class GeGluMlp(torch.nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            self.w0 = torch.nn.Linear(dim, hidden)
            self.w1 = torch.nn.Linear(dim, hidden)
            self.w2 = torch.nn.Linear(hidden, dim)

        def forward(self, x):
            x = self.norm(x)
            return self.w2(torch.nn.functional.gelu(self.w0(x)) * self.w1(x))

    class Block(torch.nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.attn = Attn(dim, heads)
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.mlp = GeGluMlp(dim, int(dim * 2.0))

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))

    class Backbone(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            c1, c2 = cfg.mbconv_dims
            self.stem = Stem(3, c1)
            stages = []
            cin = c1
            for chs, depth in zip(cfg.mbconv_dims, cfg.mbconv_depths):
                blocks = []
                for i in range(depth):
                    blocks.append(MbConvLNBlock(cin, chs, 2 if i == 0 else 1))
                    cin = chs
                stages.append(torch.nn.Sequential(*blocks))
            self.stages = torch.nn.Sequential(*stages)
            self.pool = StridedConv(c2, cfg.width)

        def forward(self, x):
            return self.pool(self.stages(self.stem(x)))

    class PatchEmbed(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.backbone = Backbone(cfg)

        def forward(self, x):
            return self.backbone(x).flatten(2).transpose(1, 2)

    class Trunk(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.patch_embed = PatchEmbed(cfg)
            g = cfg.image_size // 16
            self.pos_embed = torch.nn.Parameter(
                torch.randn(1, g * g, cfg.width) * 0.02)
            self.blocks = torch.nn.ModuleList(
                [Block(cfg.width, cfg.heads) for _ in range(cfg.depth)])
            self.fc_norm = torch.nn.LayerNorm(cfg.width, eps=1e-6)

        def forward(self, x):
            x = self.patch_embed(x) + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            return self.fc_norm(x.mean(dim=1))

    class Head(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.proj = torch.nn.Linear(cfg.width, cfg.embed_dim, bias=False)

        def forward(self, x):
            return self.proj(x)

    class Model(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.trunk = Trunk(cfg)
            self.head = Head(cfg)

        def forward(self, x):
            return self.head(self.trunk(x))

    torch.manual_seed(0)
    return Model(tiny_cfg()).eval()


def test_vitamin_parity(torch_vitamin):
    import torch

    cfg = tiny_cfg()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_vitamin(
            torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    model = VitaminTower(cfg)
    params = convert_vitamin_trunk_state_dict(
        {"visual." + k: v for k, v in torch_vitamin.state_dict().items()}
    )
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)
    assert tokens.shape == (2, 16, 48)  # 64/16 = 4x4 tokens


def test_vitamin_registry_and_factory():
    from clip_embeds.core.config import get_model_config
    from clip_embeds.core.openclip_registry import classify_model

    for name in ("ViTamin-S", "ViTamin-B", "ViTamin-L", "ViTamin-L-336",
                 "ViTamin-L2", "ViTamin-XL-256"):
        backend, detail = classify_model(name)
        assert backend == "clip", (name, backend, detail)

    cfg = get_model_config("ViTamin-L-336")
    assert cfg.vision.tower == "vitamin"
    assert cfg.vision.width == 1024 and cfg.vision.layers == 31
    assert cfg.vision.vitamin_mbconv_dims == (160, 320)
    assert cfg.embed_dim == 768 and cfg.vision.image_size == 336

    vc = vitamin_config("vitamin_xlarge_256", 256, 1152)
    assert vc.width == 1152 and vc.depth == 32

    # tiny stand-in through the CLIP assembly
    from clip_embeds.core.config import CLIPConfig, TextConfig, VisionConfig
    from clip_embeds.models.clip import CLIP

    clip_cfg = CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(
            tower="vitamin", image_size=64, width=48, layers=2,
            head_width=12, mlp_ratio=2.0,
            vitamin_mbconv_dims=(16, 24), vitamin_mbconv_depths=(2, 2),
        ),
        text=TextConfig(context_length=12, vocab_size=64, width=32, heads=2,
                        layers=2),
    )
    model = CLIP(clip_cfg)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 12), jnp.int32),
    )["params"]
    out = model.apply({"params": params}, jnp.zeros((1, 64, 64, 3)),
                      jnp.zeros((1, 12), jnp.int32))
    assert out["image_features"].shape == (1, 32)
