"""ConvNeXt tower parity vs a torch replica of the timm trunk layout
(reference routes convnext_* configs through timm — timm_model.py:23-103),
plus registry wiring for the 11 convnext model configs."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.models.convnext import (
    ConvNeXtConfig,
    ConvNeXtTower,
    convert_convnext_tower,
)

torch = pytest.importorskip("torch")
from torch import nn  # noqa: E402

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


class LayerNorm2d(nn.LayerNorm):
    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = super().forward(x)
        return x.permute(0, 3, 1, 2)


class Block(nn.Module):
    """timm ConvNeXtBlock (conv_mlp=False): dw conv -> LN -> mlp -> gamma."""

    def __init__(self, dim):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Sequential()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(1e-6 * torch.ones(dim))

    def forward(self, x):
        shortcut = x
        x = self.conv_dw(x).permute(0, 2, 3, 1)
        x = self.norm(x)
        x = self.mlp.fc2(nn.functional.gelu(self.mlp.fc1(x)))
        x = (self.gamma * x).permute(0, 3, 1, 2)
        return shortcut + x


class TorchConvNeXtCLIPVisual(nn.Module):
    """open_clip TimmModel(convnext, pool='', proj=...) replica: trunk with
    default avg pool + norm, then the open_clip head projection."""

    def __init__(self, depths, dims, embed_dim, proj):
        super().__init__()
        trunk = nn.Module()
        trunk.stem = nn.Sequential(
            nn.Conv2d(3, dims[0], 4, stride=4),
            LayerNorm2d(dims[0], eps=1e-6),
        )
        trunk.stages = nn.ModuleList()
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            stage = nn.Module()
            if si > 0:
                stage.downsample = nn.Sequential(
                    LayerNorm2d(dims[si - 1], eps=1e-6),
                    nn.Conv2d(dims[si - 1], dim, 2, stride=2),
                )
            stage.blocks = nn.ModuleList(Block(dim) for _ in range(depth))
            trunk.stages.append(stage)
        trunk.head = nn.Module()
        trunk.head.norm = nn.LayerNorm(dims[-1], eps=1e-6)
        self.trunk = trunk
        self.head = nn.Module()
        if proj == "linear":
            self.head.proj = nn.Linear(dims[-1], embed_dim, bias=False)
        else:
            self.head.mlp = nn.Sequential()
            self.head.mlp.fc1 = nn.Linear(dims[-1], 2 * embed_dim)
            self.head.mlp.fc2 = nn.Linear(2 * embed_dim, embed_dim, bias=False)

    def forward(self, x):
        x = self.trunk.stem(x)
        for stage in self.trunk.stages:
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
            for blk in stage.blocks:
                x = blk(x)
        x = x.mean(dim=(2, 3))
        x = self.trunk.head.norm(x)
        if hasattr(self.head, "proj"):
            return self.head.proj(x)
        return self.head.mlp.fc2(
            nn.functional.gelu(self.head.mlp.fc1(x))
        )


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_convnext_tower_parity(proj):
    torch.manual_seed(0)
    depths, dims = (2, 2), (16, 32)
    ref = TorchConvNeXtCLIPVisual(depths, dims, 24, proj).eval()
    # perturb gammas so layer-scale conversion is actually exercised
    with torch.no_grad():
        for p in ref.named_parameters():
            if p[0].endswith("gamma"):
                p[1].copy_(torch.randn_like(p[1]) * 0.1)

    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.tensor(img)).numpy()

    cfg = ConvNeXtConfig(depths=depths, dims=dims, embed_dim=24, proj=proj,
                         image_size=32)
    sd = {"visual." + k: v for k, v in ref.state_dict().items()}
    params = convert_convnext_tower(sd, cfg)
    tower = ConvNeXtTower(cfg)
    got, tokens = tower.apply(
        {"params": params}, jnp.asarray(img.transpose(0, 2, 3, 1))
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)
    assert tokens.shape == (2, 4 * 4, 32)  # 32px /4 stem /2 downsample


def test_registry_resolves_convnext_natively():
    from clip_embeds.core.config import get_model_config
    from clip_embeds.core.openclip_registry import classify_model

    assert classify_model("convnext_base_w")[0] == "clip"
    cfg = get_model_config("convnext_base_w")
    assert cfg.vision.tower == "convnext"
    assert cfg.vision.convnext_dims == (128, 256, 512, 1024)
    assert cfg.vision.image_size == 256 and cfg.embed_dim == 640

    # large_d uses the mlp head projection
    d = get_model_config("convnext_large_d")
    assert d.vision.head_proj == "mlp"
    xx = get_model_config("convnext_xxlarge")
    assert xx.vision.convnext_depths == (3, 4, 30, 3)


def test_tiny_convnext_clip_forward():
    from clip_embeds.core.config import CLIPConfig, TextConfig, VisionConfig
    from clip_embeds.models.clip import CLIP

    cfg = CLIPConfig(
        embed_dim=24,
        vision=VisionConfig(tower="convnext", image_size=32,
                            convnext_depths=(1, 1), convnext_dims=(8, 16)),
        text=TextConfig(width=32, heads=2, layers=2, vocab_size=64,
                        context_length=16),
    )
    model = CLIP(cfg)
    import jax

    imgs = jnp.zeros((2, 32, 32, 3))
    txts = jnp.zeros((2, 16), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), imgs, txts)["params"]
    out = model.apply({"params": params}, imgs, txts)
    assert out["image_features"].shape == (2, 24)
    assert out["text_features"].shape == (2, 24)
