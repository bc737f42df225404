"""MobileCLIP-B vision tower (timm vit_base_mci_224 hybrid ViT) parity vs a
torch replica with timm module naming (timm absent in this image), incl. the
stem BatchNorm folding performed at convert time.

Reference contract: open_clip MobileCLIP-B.json (timm trunk, pool 'token',
proj null -> the timm classifier head Linear(768, 512) is the projection);
timm vision_transformer_hybrid ConvStem + no_embed_class ViT-B.
"""

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

from clip_embeds.models.mci_vit import (  # noqa: E402
    MCiViTConfig,
    MCiViTTower,
    convert_mci_vit_state_dict,
)


def tiny_cfg() -> MCiViTConfig:
    return MCiViTConfig(image_size=32, width=48, depth=2, heads=4,
                        mlp_ratio=4.0, embed_dim=24)


@pytest.fixture(scope="module")
def torch_mci_vit():
    torch = pytest.importorskip("torch")

    class ConvNormAct(torch.nn.Module):
        """timm ConvNormAct: conv (no bias) + BatchNormAct2d(GELU)."""

        def __init__(self, cin, cout, k):
            super().__init__()
            self.conv = torch.nn.Conv2d(cin, cout, k, stride=k, bias=False)
            self.bn = torch.nn.BatchNorm2d(cout)

        def forward(self, x):
            return torch.nn.functional.gelu(self.bn(self.conv(x)))

    class LastConv(torch.nn.Module):
        """Final stem stage: biased conv, no norm, no act."""

        def __init__(self, cin, cout, k):
            super().__init__()
            self.conv = torch.nn.Conv2d(cin, cout, k, stride=k, bias=True)

        def forward(self, x):
            return self.conv(x)

    class Block(torch.nn.Module):
        def __init__(self, dim, heads, hidden):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)

            class Attn(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.qkv = torch.nn.Linear(dim, 3 * dim, bias=True)
                    self.proj = torch.nn.Linear(dim, dim)

                def forward(self, x):
                    b, n, d = x.shape
                    hd = d // heads
                    q, k, v = self.qkv(x).chunk(3, -1)

                    def split(t):
                        return t.reshape(b, n, heads, hd).transpose(1, 2)

                    q, k, v = split(q), split(k), split(v)
                    a = ((q @ k.transpose(-2, -1)) * hd ** -0.5).softmax(-1)
                    return self.proj(
                        (a @ v).transpose(1, 2).reshape(b, n, d))

            self.attn = Attn()
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(dim, hidden)
            self.mlp.fc2 = torch.nn.Linear(hidden, dim)

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            h = torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x)))
            return x + self.mlp.fc2(h)

    class Trunk(torch.nn.Module):
        def __init__(self, dim=48, heads=4, depth=2, img=32):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.backbone = torch.nn.Sequential(
                        ConvNormAct(3, dim // 4, 4),
                        ConvNormAct(dim // 4, dim // 4, 2),
                        LastConv(dim // 4, dim, 2),
                    )

                def forward(self, x):
                    return self.backbone(x)

            self.patch_embed = PE()
            g = img // 16
            self.cls_token = torch.nn.Parameter(torch.randn(1, 1, dim) * .02)
            self.pos_embed = torch.nn.Parameter(
                torch.randn(1, g * g, dim) * 0.02)
            self.blocks = torch.nn.ModuleList(
                [Block(dim, heads, 4 * dim) for _ in range(depth)])
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            self.head = torch.nn.Linear(dim, 24, bias=True)

        def forward(self, x):
            x = self.patch_embed(x).flatten(2).transpose(1, 2)
            # no_embed_class: pos over patch tokens, cls prepended after
            x = x + self.pos_embed
            x = torch.cat(
                [self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
            for blk in self.blocks:
                x = blk(x)
            return self.head(self.norm(x)[:, 0])

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = Trunk()

        def forward(self, x):
            return self.trunk(x)

    torch.manual_seed(0)
    model = Model()
    # populate non-trivial BN running stats so the folding is actually tested
    with torch.no_grad():
        for _ in range(3):
            model(torch.randn(4, 3, 32, 32))
    return model.eval()


def test_mci_vit_parity(torch_mci_vit):
    import torch

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_mci_vit(torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    model = MCiViTTower(tiny_cfg())
    params = convert_mci_vit_state_dict(
        {"visual." + k: v for k, v in torch_mci_vit.state_dict().items()}
    )
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)
    assert tokens.shape == (2, 4, 48)


def test_mobileclip_b_registry_native():
    from clip_embeds.core.config import get_model_config
    from clip_embeds.core.openclip_registry import classify_model

    backend, detail = classify_model("MobileCLIP-B")
    assert backend == "clip", detail
    cfg = get_model_config("MobileCLIP-B")
    assert cfg.vision.tower == "mci-vit"
    assert cfg.vision.width == 768 and cfg.vision.image_size == 224
    assert cfg.embed_dim == 512
    # MobileCLIP-B text: standard causal 12x512 transformer
    assert cfg.text.width == 512 and not cfg.text.no_causal_mask


def test_mci_vit_full_model_convert(torch_mci_vit):
    """convert_clip_state_dict dispatches the backbone.0 stem layout and
    assembles the custom_text ('text.'-prefixed) text tower."""
    import torch

    from clip_embeds.core.config import CLIPConfig, TextConfig, VisionConfig
    from clip_embeds.core.torch_convert import convert_clip_state_dict
    from clip_embeds.models.clip import CLIP

    torch.manual_seed(1)
    d, layers, ctx, vocab = 32, 2, 12, 64
    text_sd = {}
    text_sd["text.token_embedding.weight"] = torch.randn(vocab, d)
    text_sd["text.positional_embedding"] = torch.randn(ctx, d)
    for i in range(layers):
        p = f"text.transformer.resblocks.{i}"
        text_sd[f"{p}.ln_1.weight"] = torch.ones(d)
        text_sd[f"{p}.ln_1.bias"] = torch.zeros(d)
        text_sd[f"{p}.attn.in_proj_weight"] = torch.randn(3 * d, d) * 0.02
        text_sd[f"{p}.attn.in_proj_bias"] = torch.zeros(3 * d)
        text_sd[f"{p}.attn.out_proj.weight"] = torch.randn(d, d) * 0.02
        text_sd[f"{p}.attn.out_proj.bias"] = torch.zeros(d)
        text_sd[f"{p}.ln_2.weight"] = torch.ones(d)
        text_sd[f"{p}.ln_2.bias"] = torch.zeros(d)
        text_sd[f"{p}.mlp.c_fc.weight"] = torch.randn(4 * d, d) * 0.02
        text_sd[f"{p}.mlp.c_fc.bias"] = torch.zeros(4 * d)
        text_sd[f"{p}.mlp.c_proj.weight"] = torch.randn(d, 4 * d) * 0.02
        text_sd[f"{p}.mlp.c_proj.bias"] = torch.zeros(d)
    text_sd["text.ln_final.weight"] = torch.ones(d)
    text_sd["text.ln_final.bias"] = torch.zeros(d)
    text_sd["text.text_projection"] = torch.randn(d, 24)

    sd = {"visual." + k: v for k, v in torch_mci_vit.state_dict().items()}
    sd.update(text_sd)
    sd["logit_scale"] = torch.tensor(2.6593)

    params = convert_clip_state_dict(sd, vision_tower="mci-vit")
    cfg = CLIPConfig(
        embed_dim=24,
        vision=VisionConfig(tower="mci-vit", image_size=32, width=48,
                            layers=2, head_width=12),
        text=TextConfig(context_length=ctx, vocab_size=vocab, width=d,
                        heads=2, layers=layers),
    )
    model = CLIP(cfg)
    out = model.apply(
        {"params": params},
        jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1, ctx), jnp.int32),
    )
    assert out["image_features"].shape == (1, 24)
    assert out["text_features"].shape == (1, 24)
