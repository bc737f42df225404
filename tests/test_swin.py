"""Swin tower parity vs a torch replica of the timm swin layout
(windowed/shifted attention with relative position bias, patch merging)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

from clip_embeds.models.swin import (  # noqa: E402
    SwinConfig,
    SwinTower,
    convert_swin_trunk_state_dict,
    relative_position_index,
)


def tiny_cfg() -> SwinConfig:
    # 32px, patch 2 -> 16x16; window 4; two stages
    return SwinConfig(image_size=32, patch_size=2, embed_dim=16,
                      depths=(2, 2), heads=(2, 4), window=4, out_dim=24)


@pytest.fixture(scope="module")
def torch_swin():
    torch = pytest.importorskip("torch")
    cfg = tiny_cfg()

    def window_partition(x, w):
        b, h, ww, c = x.shape
        x = x.view(b, h // w, w, ww // w, w, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)

    def window_reverse(x, w, h, ww):
        b = x.shape[0] // (h // w * (ww // w))
        x = x.view(b, h // w, ww // w, w, w, -1)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)

    class WindowAttn(torch.nn.Module):
        def __init__(self, dim, heads, window):
            super().__init__()
            self.heads = heads
            self.window = window
            self.qkv = torch.nn.Linear(dim, 3 * dim, bias=True)
            self.proj = torch.nn.Linear(dim, dim)
            self.relative_position_bias_table = torch.nn.Parameter(
                torch.randn((2 * window - 1) ** 2, heads) * 0.02)
            self.register_buffer(
                "relative_position_index",
                torch.tensor(relative_position_index(window)),
                persistent=False,
            )

        def forward(self, x, mask=None):
            nw, ww, d = x.shape
            hd = d // self.heads
            q, k, v = self.qkv(x).chunk(3, -1)

            def split(t):
                return t.reshape(nw, ww, self.heads, hd).transpose(1, 2)

            q, k, v = split(q), split(k), split(v)
            s = (q @ k.transpose(-2, -1)) * hd ** -0.5
            bias = self.relative_position_bias_table[
                self.relative_position_index.view(-1)
            ].view(ww, ww, self.heads).permute(2, 0, 1)
            s = s + bias.unsqueeze(0)
            if mask is not None:
                nm = mask.shape[0]
                s = s.view(nw // nm, nm, self.heads, ww, ww)
                s = s + mask.unsqueeze(1).unsqueeze(0)
                s = s.view(nw, self.heads, ww, ww)
            a = s.softmax(-1)
            return self.proj((a @ v).transpose(1, 2).reshape(nw, ww, d))

    class Block(torch.nn.Module):
        def __init__(self, dim, heads, window, shift, resolution):
            super().__init__()
            self.window, self.shift = window, shift
            self.norm1 = torch.nn.LayerNorm(dim)
            self.attn = WindowAttn(dim, heads, window)
            self.norm2 = torch.nn.LayerNorm(dim)
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(dim, 4 * dim)
            self.mlp.fc2 = torch.nn.Linear(4 * dim, dim)
            if shift:
                h, w = resolution
                img = torch.zeros(1, h, w, 1)
                cnt = 0
                for hs in (slice(0, -window), slice(-window, -shift),
                           slice(-shift, None)):
                    for ws in (slice(0, -window), slice(-window, -shift),
                               slice(-shift, None)):
                        img[:, hs, ws, :] = cnt
                        cnt += 1
                mw = window_partition(img, window).view(-1, window * window)
                mask = mw.unsqueeze(1) - mw.unsqueeze(2)
                self.register_buffer(
                    "attn_mask",
                    torch.where(mask != 0, -100.0, 0.0), persistent=False)
            else:
                self.attn_mask = None

        def forward(self, x):
            b, h, w, d = x.shape
            shortcut = x
            x = self.norm1(x)
            if self.shift:
                x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
            windows = window_partition(x, self.window)
            o = self.attn(windows, self.attn_mask)
            o = window_reverse(o, self.window, h, w)
            if self.shift:
                o = torch.roll(o, (self.shift, self.shift), dims=(1, 2))
            x = shortcut + o
            h2 = torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x)))
            return x + self.mlp.fc2(h2)

    class PatchMerging(torch.nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.norm = torch.nn.LayerNorm(4 * dim)
            self.reduction = torch.nn.Linear(4 * dim, 2 * dim, bias=False)

        def forward(self, x):
            x0 = x[:, 0::2, 0::2]
            x1 = x[:, 1::2, 0::2]
            x2 = x[:, 0::2, 1::2]
            x3 = x[:, 1::2, 1::2]
            x = torch.cat([x0, x1, x2, x3], -1)
            return self.reduction(self.norm(x))

    class Layer(torch.nn.Module):
        def __init__(self, dim, depth, heads, window, resolution, last):
            super().__init__()
            self.blocks = torch.nn.ModuleList([
                Block(dim, heads, window, 0 if i % 2 == 0 else window // 2,
                      resolution)
                for i in range(depth)
            ])
            self.downsample = None if last else PatchMerging(dim)

        def forward(self, x):
            for blk in self.blocks:
                x = blk(x)
            if self.downsample is not None:
                x = self.downsample(x)
            return x

    class PE(torch.nn.Module):
        def __init__(self, dim, patch):
            super().__init__()
            self.proj = torch.nn.Conv2d(3, dim, patch, patch)
            self.norm = torch.nn.LayerNorm(dim)

        def forward(self, x):
            x = self.proj(x).permute(0, 2, 3, 1)
            return self.norm(x)

    class Trunk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.patch_embed = PE(cfg.embed_dim, cfg.patch_size)
            res = cfg.image_size // cfg.patch_size
            layers = []
            dim = cfg.embed_dim
            for s, (depth, heads) in enumerate(zip(cfg.depths, cfg.heads)):
                layers.append(Layer(dim, depth, heads, cfg.window,
                                    (res, res),
                                    s == len(cfg.depths) - 1))
                if s < len(cfg.depths) - 1:
                    dim *= 2
                    res //= 2
            self.layers = torch.nn.ModuleList(layers)
            self.norm = torch.nn.LayerNorm(dim)

        def forward(self, x):
            x = self.patch_embed(x)
            for layer in self.layers:
                x = layer(x)
            b, h, w, c = x.shape
            x = self.norm(x.reshape(b, h * w, c))
            return x.mean(dim=1)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = Trunk()

            class Head(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Linear(
                        cfg.num_features, cfg.out_dim, bias=False)

            self.head = Head()

        def forward(self, x):
            return self.head.proj(self.trunk(x))

    torch.manual_seed(0)
    return Model().eval()


def test_swin_parity(torch_swin):
    import torch

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_swin(torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    model = SwinTower(tiny_cfg())
    params = convert_swin_trunk_state_dict(
        {"visual." + k: v for k, v in torch_swin.state_dict().items()}
    )
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)
    assert tokens.shape == (2, 64, 32)  # 8x8 at dim 32 after one merge


def test_swin_registry_native():
    from clip_embeds.core.config import get_model_config
    from clip_embeds.core.openclip_registry import classify_model

    backend, detail = classify_model("swin_base_patch4_window7_224")
    assert backend == "clip", detail
    cfg = get_model_config("swin_base_patch4_window7_224")
    assert cfg.vision.tower == "swin"
    assert cfg.vision.swin_depths == (2, 2, 18, 2)
    assert cfg.embed_dim == 640
