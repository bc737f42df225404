"""EVA tower parity vs a torch replica of the timm eva_giant layout
(timm is not installed in this image; the replica follows the documented
BEiT-style attention with split q/v biases, which the converter also
handles in fused form)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.eva import (
    EVAVisionTower,
    convert_eva_trunk_state_dict,
    eva_giant_config,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def tiny_cfg() -> VisionConfig:
    return VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                        head_width=16, mlp_ratio=2.0, tower="eva")


@pytest.fixture(scope="module")
def torch_trunk():
    torch = pytest.importorskip("torch")

    class Attn(torch.nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.heads = heads
            self.qkv = torch.nn.Linear(dim, dim * 3, bias=False)
            self.q_bias = torch.nn.Parameter(torch.randn(dim) * 0.02)
            self.v_bias = torch.nn.Parameter(torch.randn(dim) * 0.02)
            self.proj = torch.nn.Linear(dim, dim)

        def forward(self, x):
            b, n, d = x.shape
            hd = d // self.heads
            bias = torch.cat(
                [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]
            )
            qkv = torch.nn.functional.linear(x, self.qkv.weight, bias)
            q, k, v = qkv.chunk(3, dim=-1)

            def split(t):
                return t.reshape(b, n, self.heads, hd).transpose(1, 2)

            q, k, v = split(q), split(k), split(v)
            attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
            attn = attn.softmax(dim=-1)
            out = (attn @ v).transpose(1, 2).reshape(b, n, d)
            return self.proj(out)

    class Block(torch.nn.Module):
        def __init__(self, dim, heads, mlp):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.attn = Attn(dim, heads)
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(dim, mlp)
            self.mlp.fc2 = torch.nn.Linear(mlp, dim)

        def forward(self, x):
            x = x + self.attn(self.norm1(x))
            h = self.mlp.fc1(self.norm2(x))
            h = torch.nn.functional.gelu(h)
            return x + self.mlp.fc2(h)

    class Trunk(torch.nn.Module):
        def __init__(self, dim=64, heads=4, depth=2, patch=16, img=32,
                     embed=48, mlp=128):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Conv2d(3, dim, patch, patch)

            self.patch_embed = PE()
            self.cls_token = torch.nn.Parameter(torch.randn(1, 1, dim) * 0.02)
            n = (img // patch) ** 2 + 1
            self.pos_embed = torch.nn.Parameter(torch.randn(1, n, dim) * 0.02)
            self.blocks = torch.nn.ModuleList(
                [Block(dim, heads, mlp) for _ in range(depth)]
            )
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            self.head = torch.nn.Linear(dim, embed)

        def forward(self, x):
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = torch.cat(
                [self.cls_token.expand(x.shape[0], -1, -1), x], dim=1
            )
            x = x + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            x = self.norm(x)
            return self.head(x[:, 0])

    torch.manual_seed(0)
    return Trunk().eval()


def test_eva_parity(torch_trunk):
    import torch

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_trunk(torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    model = EVAVisionTower(tiny_cfg(), embed_dim=48, attn_impl="reference")
    params = convert_eva_trunk_state_dict(
        {"visual.trunk." + k: v for k, v in torch_trunk.state_dict().items()}
    )
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)
    assert tokens.shape == (2, 4, 64)


def test_eva_in_clip_factory():
    from clip_embeds.core.factory import create_model

    cfg = eva_giant_config()
    assert cfg.width == 1408 and cfg.layers == 40
    # tiny stand-in through the same CLIP wiring
    from clip_embeds.core.config import CLIPConfig, TextConfig
    from clip_embeds.models.clip import CLIP

    clip_cfg = CLIPConfig(
        embed_dim=48,
        vision=tiny_cfg(),
        text=TextConfig(context_length=12, vocab_size=64, width=32, heads=2,
                        layers=2),
    )
    model = CLIP(clip_cfg, attn_impl="reference")
    images = jnp.zeros((1, 32, 32, 3))
    text = jnp.zeros((1, 12), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), images, text)["params"]
    out = model.apply({"params": params}, images, text)
    assert out["image_features"].shape == (1, 48)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out["image_features"]), axis=-1), 1.0,
        rtol=1e-5,
    )


# -- EVA02 -------------------------------------------------------------------


@pytest.fixture(scope="module")
def torch_eva02():
    """Torch replica of the timm eva.py EVA02-CLIP block (split q/k/v with
    bias-less k, 2D cat-rope with ref_feat_shape rescale and cls excluded,
    LN on attention output, SwiGLU MLP with inner LN, pre-norm)."""
    torch = pytest.importorskip("torch")

    def build_rope(grid, head_dim, ref_shape, temperature=10000.0):
        nb = head_dim // 4
        bands = 1.0 / (temperature ** (torch.arange(nb).float() / nb))
        ts = [torch.arange(s).float() / s * r
              for s, r in zip(grid, ref_shape)]
        mesh = torch.stack(torch.meshgrid(*ts, indexing="ij"), dim=-1)
        pos = mesh.unsqueeze(-1) * bands
        n = grid[0] * grid[1]
        sin = pos.sin().reshape(n, -1).repeat_interleave(2, -1)
        cos = pos.cos().reshape(n, -1).repeat_interleave(2, -1)
        return sin, cos

    def rot(x):
        return torch.stack(
            [-x[..., 1::2], x[..., ::2]], -1
        ).reshape(x.shape)

    class Attn(torch.nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.heads = heads
            self.q_proj = torch.nn.Linear(dim, dim, bias=True)
            self.k_proj = torch.nn.Linear(dim, dim, bias=False)
            self.v_proj = torch.nn.Linear(dim, dim, bias=True)
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            self.proj = torch.nn.Linear(dim, dim)

        def forward(self, x, sin, cos):
            b, n, d = x.shape
            hd = d // self.heads

            def split(t):
                return t.reshape(b, n, self.heads, hd).transpose(1, 2)

            q = split(self.q_proj(x))
            k = split(self.k_proj(x))
            v = split(self.v_proj(x))
            q = torch.cat(
                [q[:, :, :1], q[:, :, 1:] * cos + rot(q[:, :, 1:]) * sin], 2
            )
            k = torch.cat(
                [k[:, :, :1], k[:, :, 1:] * cos + rot(k[:, :, 1:]) * sin], 2
            )
            attn = (q @ k.transpose(-2, -1)) * hd ** -0.5
            attn = attn.softmax(dim=-1)
            out = (attn @ v).transpose(1, 2).reshape(b, n, d)
            return self.proj(self.norm(out))

    class SwiGLU(torch.nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.fc1_g = torch.nn.Linear(dim, hidden)
            self.fc1_x = torch.nn.Linear(dim, hidden)
            self.norm = torch.nn.LayerNorm(hidden, eps=1e-6)
            self.fc2 = torch.nn.Linear(hidden, dim)

        def forward(self, x):
            h = torch.nn.functional.silu(self.fc1_g(x)) * self.fc1_x(x)
            return self.fc2(self.norm(h))

    class Block(torch.nn.Module):
        def __init__(self, dim, heads, hidden):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.attn = Attn(dim, heads)
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.mlp = SwiGLU(dim, hidden)

        def forward(self, x, sin, cos):
            x = x + self.attn(self.norm1(x), sin, cos)
            return x + self.mlp(self.norm2(x))

    class Trunk(torch.nn.Module):
        def __init__(self, dim=64, heads=4, depth=2, patch=16, img=32,
                     embed=48, ref=(16, 16)):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Conv2d(3, dim, patch, patch)

            self.patch_embed = PE()
            g = img // patch
            self.cls_token = torch.nn.Parameter(torch.randn(1, 1, dim) * .02)
            self.pos_embed = torch.nn.Parameter(
                torch.randn(1, g * g + 1, dim) * 0.02)
            hidden = int(dim * 8 / 3)
            self.blocks = torch.nn.ModuleList(
                [Block(dim, heads, hidden) for _ in range(depth)])
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            self.head = torch.nn.Linear(dim, embed)
            self.sin, self.cos = build_rope((g, g), dim // heads, ref)

        def forward(self, x):
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = torch.cat(
                [self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
            x = x + self.pos_embed
            for blk in self.blocks:
                x = blk(x, self.sin, self.cos)
            return self.head(self.norm(x)[:, 0])

    torch.manual_seed(1)
    return Trunk().eval()


def eva02_tiny_cfg() -> VisionConfig:
    return VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                        head_width=16, mlp_ratio=8 / 3, tower="eva02",
                        eva_rope=True, eva_swiglu=True,
                        eva_attn_inner_norm=True, eva_ref_feat_shape=(16, 16))


def test_eva02_parity(torch_eva02):
    import torch

    from clip_embeds.models.eva import (
        EVA02VisionTower,
        convert_eva02_trunk_state_dict,
    )

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_eva02(torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    model = EVA02VisionTower(eva02_tiny_cfg(), embed_dim=48,
                             attn_impl="reference")
    params = convert_eva02_trunk_state_dict(
        {"visual.trunk." + k: v for k, v in torch_eva02.state_dict().items()}
    )
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)
    assert tokens.shape == (2, 4, 64)


def test_eva02_post_norm_variant():
    """EVA02-E layout: fused qkv [q;0;v] bias, plain GELU MLP, post-norm."""
    torch = pytest.importorskip("torch")

    from clip_embeds.models.eva import (
        EVA02VisionTower,
        convert_eva02_trunk_state_dict,
    )

    class Attn(torch.nn.Module):
        def __init__(self, dim, heads):
            super().__init__()
            self.heads = heads
            self.qkv = torch.nn.Linear(dim, dim * 3, bias=False)
            self.q_bias = torch.nn.Parameter(torch.randn(dim) * 0.02)
            self.v_bias = torch.nn.Parameter(torch.randn(dim) * 0.02)
            self.proj = torch.nn.Linear(dim, dim)

        def forward(self, x):
            b, n, d = x.shape
            hd = d // self.heads
            bias = torch.cat(
                [self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
            qkv = torch.nn.functional.linear(x, self.qkv.weight, bias)
            q, k, v = qkv.chunk(3, dim=-1)

            def split(t):
                return t.reshape(b, n, self.heads, hd).transpose(1, 2)

            q, k, v = split(q), split(k), split(v)
            attn = ((q @ k.transpose(-2, -1)) * hd ** -0.5).softmax(-1)
            return self.proj(
                (attn @ v).transpose(1, 2).reshape(b, n, d))

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
            x = x + self.norm1(self.attn(x))
            h = torch.nn.functional.gelu(self.mlp.fc1(x))
            return x + self.norm2(self.mlp.fc2(h))

    class Trunk(torch.nn.Module):
        def __init__(self, dim=64, heads=4, depth=2, patch=16, img=32,
                     embed=48):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Conv2d(3, dim, patch, patch)

            self.patch_embed = PE()
            g = img // patch
            self.cls_token = torch.nn.Parameter(torch.randn(1, 1, dim) * .02)
            self.pos_embed = torch.nn.Parameter(
                torch.randn(1, g * g + 1, dim) * 0.02)
            self.blocks = torch.nn.ModuleList(
                [Block(dim, heads, 2 * dim) for _ in range(depth)])
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)
            self.head = torch.nn.Linear(dim, embed)

        def forward(self, x):
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = torch.cat(
                [self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
            x = x + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            return self.head(self.norm(x)[:, 0])

    torch.manual_seed(2)
    trunk = Trunk().eval()
    cfg = VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                       head_width=16, mlp_ratio=2.0, tower="eva02",
                       eva_post_norm=True)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    import torch as _t

    with _t.no_grad():
        ref = trunk(_t.tensor(images).permute(0, 3, 1, 2)).numpy()
    model = EVA02VisionTower(cfg, embed_dim=48, attn_impl="reference")
    params = convert_eva02_trunk_state_dict(
        {"visual.trunk." + k: v for k, v in trunk.state_dict().items()}
    )
    pooled, _ = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=3e-4, atol=3e-4)


def test_eva02_registry_native():
    """EVA02-* names classify as native clip and build through the factory."""
    from clip_embeds.core.openclip_registry import classify_model
    from clip_embeds.models.eva import eva02_vision_config

    for name in ("EVA02-B-16", "EVA02-L-14", "EVA02-L-14-336",
                 "EVA02-E-14", "EVA02-E-14-plus"):
        backend, detail = classify_model(name)
        assert backend == "clip", (name, backend, detail)

    cfg = eva02_vision_config("eva02_large_patch14_clip_336", 336)
    assert cfg.width == 1024 and cfg.layers == 24 and cfg.eva_rope
    assert int(cfg.width * cfg.mlp_ratio) == 2730

    from clip_embeds.core.config import get_model_config

    full = get_model_config("EVA02-L-14-336")
    assert full.vision.tower == "eva02" and full.embed_dim == 768
    assert full.vision.image_size == 336


def test_eva02_custom_text_checkpoint_conversion(torch_eva02, tmp_path):
    """Full CustomTextCLIP layout (visual.trunk.* + text.*) through
    load_torch_checkpoint into the CLIP assembly."""
    import torch

    from clip_embeds.core.config import CLIPConfig, TextConfig
    from clip_embeds.core.factory import load_params
    from clip_embeds.models.clip import CLIP

    # reference text tower (plain CLIP text half) under the 'text.' prefix
    from clip_embeds.cli.parity import _load_refoc

    ref_model_module, _ = _load_refoc()

    torch.manual_seed(3)
    text_tower = ref_model_module.TextTransformer(
        context_length=12, vocab_size=128, width=32, heads=2, layers=2,
        output_dim=48,
    ).eval()

    sd = {"visual.trunk." + k: v for k, v in torch_eva02.state_dict().items()}
    sd.update({"text." + k: v for k, v in text_tower.state_dict().items()})
    sd["logit_scale"] = torch.tensor(2.6593)
    path = tmp_path / "eva02_custom.pt"
    torch.save(sd, str(path))

    cfg = CLIPConfig(
        embed_dim=48,
        vision=eva02_tiny_cfg(),
        text=TextConfig(context_length=12, vocab_size=128, width=32, heads=2,
                        layers=2),
    )
    params = load_params(str(path), vision_tower="eva02")
    model = CLIP(cfg, attn_impl="reference")

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    texts = np.zeros((2, 12), np.int64)
    texts[:, 0] = 1
    texts[0, 1:4] = [7, 9, 2]
    texts[1, 1:3] = [5, 2]
    out = model.apply({"params": params}, jnp.asarray(images),
                      jnp.asarray(texts.astype(np.int32)))

    with torch.no_grad():
        ref_img = torch_eva02(
            torch.tensor(images).permute(0, 3, 1, 2)).numpy()
        # NOTE: the fork's TextTransformer.forward is latently broken for
        # CustomTextCLIP (its modified text_global_pool returns a tuple that
        # forward never unpacks, transformer.py:1088-1096) — drive the
        # submodules exactly as forward would instead.
        import importlib

        ref_tf = importlib.import_module("refoc.transformer")
        t = torch.tensor(texts)
        x, attn_mask = text_tower._embeds(t)
        x = text_tower.transformer(x, attn_mask=attn_mask)
        x = text_tower.ln_final(x)
        pooled, _ = ref_tf.text_global_pool(x, t, pool_type="argmax")
        ref_txt = (pooled @ text_tower.text_projection).numpy()
    ref_img = ref_img / np.linalg.norm(ref_img, axis=-1, keepdims=True)
    ref_txt = ref_txt / np.linalg.norm(ref_txt, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(out["image_features"]), ref_img, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        np.asarray(out["text_features"]), ref_txt, rtol=3e-4, atol=3e-4)
