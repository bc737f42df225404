"""Relative-position ViT tower (vit_relpos_medium_patch16_cls_224) parity
vs a torch replica of timm's vision_transformer_relpos layout (timm absent
in this image; the replica encodes the published architecture: per-block
RelPosMlp 'cr' bias over log relative coords, LayerScale, bias-less qkv,
token pooling, linear head)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

from clip_embeds.models.vit_relpos import (  # noqa: E402
    RelPosViTConfig,
    RelPosViTTower,
    convert_relpos_vit_state_dict,
)


def tiny_cfg() -> RelPosViTConfig:
    return RelPosViTConfig(image_size=32, patch_size=8, width=48, depth=2,
                           heads=4, rel_pos_hidden=16, embed_dim=24)


@pytest.fixture(scope="module")
def torch_relpos_vit():
    torch = pytest.importorskip("torch")
    import torch.nn.functional as F

    def gen_relative_log_coords(g):
        r = torch.arange(-(g - 1), g, dtype=torch.float32)
        coords = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)
        return torch.sign(coords) * torch.log1p(coords.abs())

    def gen_relative_position_index(g):
        coords = torch.stack(torch.meshgrid(
            torch.arange(g), torch.arange(g), indexing="ij")).flatten(1)
        rel = coords[:, :, None] - coords[:, None, :]
        rel = rel.permute(1, 2, 0).contiguous()
        rel[..., 0] += g - 1
        rel[..., 1] += g - 1
        rel[..., 0] *= 2 * g - 1
        return rel.sum(-1)

    class RelPosMlp(torch.nn.Module):
        """timm layers/pos_embed_rel.py RelPosMlp, mode='cr'."""

        def __init__(self, grid, heads, hidden, prefix_tokens=1):
            super().__init__()
            self.heads = heads
            self.grid = grid
            self.prefix_tokens = prefix_tokens
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(2, hidden, bias=True)
            self.mlp.act = torch.nn.ReLU()
            self.mlp.fc2 = torch.nn.Linear(hidden, heads, bias=True)
            self.register_buffer(
                "relative_position_index",
                gen_relative_position_index(grid).view(-1),
                persistent=False)
            self.register_buffer(
                "rel_coords_log", gen_relative_log_coords(grid),
                persistent=False)

        def get_bias(self):
            n = self.grid * self.grid
            out = self.mlp.fc2(torch.relu(self.mlp.fc1(self.rel_coords_log)))
            out = out.view(-1, self.heads)[self.relative_position_index]
            out = out.view(n, n, -1).permute(2, 0, 1)
            out = F.pad(out, [self.prefix_tokens, 0, self.prefix_tokens, 0])
            return out.unsqueeze(0)

        def forward(self, attn):
            return attn + self.get_bias()

    class Attn(torch.nn.Module):
        def __init__(self, dim, heads, grid, hidden):
            super().__init__()
            self.heads = heads
            self.qkv = torch.nn.Linear(dim, 3 * dim, bias=False)
            self.rel_pos = RelPosMlp(grid, heads, hidden)
            self.proj = torch.nn.Linear(dim, dim)

        def forward(self, x):
            b, n, d = x.shape
            hd = d // self.heads
            q, k, v = self.qkv(x).chunk(3, -1)

            def split(t):
                return t.reshape(b, n, self.heads, hd).transpose(1, 2)

            q, k, v = split(q), split(k), split(v)
            a = (q @ k.transpose(-2, -1)) * hd ** -0.5
            a = self.rel_pos(a).softmax(-1)
            return self.proj((a @ v).transpose(1, 2).reshape(b, n, d))

    class LayerScale(torch.nn.Module):
        def __init__(self, dim, init=1e-6):
            super().__init__()
            self.gamma = torch.nn.Parameter(init * torch.ones(dim))

        def forward(self, x):
            return x * self.gamma

    class Block(torch.nn.Module):
        def __init__(self, dim, heads, grid, hidden):
            super().__init__()
            self.norm1 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.attn = Attn(dim, heads, grid, hidden)
            self.ls1 = LayerScale(dim)
            self.norm2 = torch.nn.LayerNorm(dim, eps=1e-6)
            self.mlp = torch.nn.Sequential()
            self.mlp.fc1 = torch.nn.Linear(dim, 4 * dim)
            self.mlp.fc2 = torch.nn.Linear(4 * dim, dim)
            self.ls2 = LayerScale(dim)

        def forward(self, x):
            x = x + self.ls1(self.attn(self.norm1(x)))
            h = torch.nn.functional.gelu(self.mlp.fc1(self.norm2(x)))
            return x + self.ls2(self.mlp.fc2(h))

    class Trunk(torch.nn.Module):
        def __init__(self, dim=48, heads=4, depth=2, patch=8, img=32,
                     hidden=16):
            super().__init__()

            class PE(torch.nn.Module):
                def __init__(self):
                    super().__init__()
                    self.proj = torch.nn.Conv2d(3, dim, patch, patch)

            self.patch_embed = PE()
            self.cls_token = torch.nn.Parameter(torch.randn(1, 1, dim) * .02)
            g = img // patch
            self.blocks = torch.nn.ModuleList(
                [Block(dim, heads, g, hidden) for _ in range(depth)])
            self.norm = torch.nn.LayerNorm(dim, eps=1e-6)

        def forward(self, x):
            x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            x = torch.cat(
                [self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
            for blk in self.blocks:
                x = blk(x)
            return self.norm(x)[:, 0]

    class Visual(torch.nn.Module):
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
    model = Visual().eval()
    return torch, model


def test_relpos_vit_parity(torch_relpos_vit):
    torch, model = torch_relpos_vit
    sd = {"visual." + k: v for k, v in model.state_dict().items()}
    params = convert_relpos_vit_state_dict(sd)

    tower = RelPosViTTower(tiny_cfg())
    rng = np.random.RandomState(0)
    imgs = rng.randn(2, 32, 32, 3).astype(np.float32)

    with torch.no_grad():
        ref = model(torch.from_numpy(imgs.transpose(0, 3, 1, 2))).numpy()

    pooled, _ = tower.apply({"params": params}, jnp.asarray(imgs))
    np.testing.assert_allclose(np.asarray(pooled), ref, atol=2e-5)


def test_relpos_param_shapes_initialise():
    tower = RelPosViTTower(tiny_cfg())
    v = tower.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    pooled, tokens = tower.apply(v, jnp.zeros((2, 32, 32, 3)))
    assert pooled.shape == (2, 24)
    assert tokens.shape == (2, 16, 48)


def test_relpos_full_size_param_count():
    """Structural check vs the reference's committed profile
    (open_clip/docs/model_profile.csv: vit_relpos_medium_patch16_cls_224
    image tower = 38.51 Mparams incl. the open_clip linear head)."""
    from clip_embeds.models.vit_relpos import RELPOS_VIT_SHAPES

    cfg = RELPOS_VIT_SHAPES["vit_relpos_medium_patch16_cls_224"]
    tower = RelPosViTTower(cfg)
    v = jax.eval_shape(
        lambda: tower.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 224, 224, 3))))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v))
    assert abs(n / 1e6 - 38.51) < 0.05, n


def test_relpos_registry_builds():
    from clip_embeds.core.openclip_registry import (
        classify_model,
        resolve_clip_config,
    )

    kind, detail = classify_model("vit_relpos_medium_patch16_cls_224")
    assert kind == "clip" and "relpos" in detail
    cfg = resolve_clip_config("vit_relpos_medium_patch16_cls_224")
    assert cfg.vision.tower == "relpos-vit"
    assert cfg.vision.width == 512 and cfg.embed_dim == 512
