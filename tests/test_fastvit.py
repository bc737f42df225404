"""FastViT-MCI tower (MobileCLIP-S1/S2) parity vs a TRAIN-MODE torch
replica with timm module naming (timm absent in this image), exercising the
complete reparameterization performed at convert time: MobileOne branch
ensembles (kxk+scale+identity BNs), the RepMixer mixer-norm difference,
ReparamLargeKernelConv 7x7+3x3 sums, RepCPE identity folding, pre-attention
BatchNorm -> qkv folding, and layer-scale -> projection folding.

Reference contract: open_clip MobileCLIP-S1/S2.json (timm fastvit_mci1/2
trunk, pool 'avg', proj null -> the timm classifier head Linear(2*dims[-1],
512) is the projection); timm fastvit.py / Apple ml-fastvit MCI variants.
"""

import numpy as np
import pytest

import jax.numpy as jnp

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

from clip_embeds.models.fastvit import (  # noqa: E402
    FastViTConfig,
    FastViTTower,
    convert_fastvit_state_dict,
    infer_fastvit_config,
)


def tiny_cfg() -> FastViTConfig:
    return FastViTConfig(image_size=64, layers=(1, 2, 1, 1),
                         dims=(16, 32, 64, 128), mlp_ratio=3.0, embed_dim=24)


@pytest.fixture(scope="module")
def torch_fastvit():
    torch = pytest.importorskip("torch")
    cfg = tiny_cfg()

    class ConvNormAct(torch.nn.Module):
        def __init__(self, cin, cout, k, stride=1, groups=1):
            super().__init__()
            self.conv = torch.nn.Conv2d(cin, cout, k, stride, k // 2,
                                        groups=groups, bias=False)
            self.bn = torch.nn.BatchNorm2d(cout)

        def forward(self, x):
            return self.bn(self.conv(x))

    class SE(torch.nn.Module):
        def __init__(self, c):
            super().__init__()
            rd = max(1, int(c * 0.0625))
            self.fc1 = torch.nn.Conv2d(c, rd, 1, bias=True)
            self.fc2 = torch.nn.Conv2d(rd, c, 1, bias=True)

        def forward(self, x):
            s = x.mean((2, 3), keepdim=True)
            s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
            return x * s

    class MobileOneBlock(torch.nn.Module):
        def __init__(self, cin, cout, k, stride=1, groups=1, use_se=False,
                     use_act=True, num_conv=1, scale_branch=True):
            super().__init__()
            self.use_act = use_act
            self.conv_kxk = torch.nn.ModuleList(
                [ConvNormAct(cin, cout, k, stride, groups)
                 for _ in range(num_conv)])
            self.conv_scale = (ConvNormAct(cin, cout, 1, stride, groups)
                               if k > 1 and scale_branch else None)
            self.identity = (torch.nn.BatchNorm2d(cout)
                             if cin == cout and stride == 1 else None)
            self.se = SE(cout) if use_se else torch.nn.Identity()

        def forward(self, x):
            y = sum(m(x) for m in self.conv_kxk)
            if self.conv_scale is not None:
                y = y + self.conv_scale(x)
            if self.identity is not None:
                y = y + self.identity(x)
            y = self.se(y)
            return torch.nn.functional.gelu(y) if self.use_act else y

    class RepMixer(torch.nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.mixer = MobileOneBlock(dim, dim, 3, groups=dim,
                                        use_act=False)
            self.norm = MobileOneBlock(dim, dim, 3, groups=dim,
                                       use_act=False, num_conv=0,
                                       scale_branch=False)
            self.layer_scale = torch.nn.ParameterDict(
                {"gamma": torch.nn.Parameter(torch.ones(dim, 1, 1))})

        def forward(self, x):
            return x + self.layer_scale["gamma"] * (
                self.mixer(x) - self.norm(x))

    class ConvMlp(torch.nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.conv = ConvNormAct(dim, dim, 7, groups=dim)
            self.fc1 = torch.nn.Conv2d(dim, hidden, 1, bias=True)
            self.fc2 = torch.nn.Conv2d(hidden, dim, 1, bias=True)

        def forward(self, x):
            h = self.conv(x)
            h = torch.nn.functional.gelu(self.fc1(h))
            return self.fc2(h)

    class RepMixerBlock(torch.nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.token_mixer = RepMixer(dim)
            self.mlp = ConvMlp(dim, hidden)
            self.layer_scale = torch.nn.ParameterDict(
                {"gamma": torch.nn.Parameter(torch.ones(dim, 1, 1))})

        def forward(self, x):
            x = self.token_mixer(x)
            return x + self.layer_scale["gamma"] * self.mlp(x)

    class Attention(torch.nn.Module):
        def __init__(self, dim, head_dim=32):
            super().__init__()
            self.heads = dim // head_dim
            self.head_dim = head_dim
            self.qkv = torch.nn.Linear(dim, 3 * dim, bias=False)
            self.proj = torch.nn.Linear(dim, dim, bias=True)

        def forward(self, x):
            b, c, h, w = x.shape
            n = h * w
            t = x.flatten(2).transpose(-2, -1)  # B,N,C
            qkv = self.qkv(t).reshape(b, n, 3, self.heads, self.head_dim)
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            a = ((q @ k.transpose(-2, -1)) * self.head_dim**-0.5).softmax(-1)
            t = (a @ v).transpose(1, 2).reshape(b, n, c)
            t = self.proj(t)
            return t.transpose(-2, -1).reshape(b, c, h, w)

    class AttentionBlock(torch.nn.Module):
        def __init__(self, dim, hidden):
            super().__init__()
            self.norm = torch.nn.BatchNorm2d(dim)
            self.token_mixer = Attention(dim)
            self.layer_scale_1 = torch.nn.ParameterDict(
                {"gamma": torch.nn.Parameter(torch.ones(dim, 1, 1))})
            self.mlp = ConvMlp(dim, hidden)
            self.layer_scale_2 = torch.nn.ParameterDict(
                {"gamma": torch.nn.Parameter(torch.ones(dim, 1, 1))})

        def forward(self, x):
            x = x + self.layer_scale_1["gamma"] * self.token_mixer(
                self.norm(x))
            return x + self.layer_scale_2["gamma"] * self.mlp(x)

    class LargeKernelConv(torch.nn.Module):
        def __init__(self, cin, cout, use_se):
            super().__init__()
            self.large_conv = ConvNormAct(cin, cout, 7, 2, groups=cin)
            self.small_conv = ConvNormAct(cin, cout, 3, 2, groups=cin)
            self.se = SE(cout) if use_se else torch.nn.Identity()

        def forward(self, x):
            y = self.large_conv(x) + self.small_conv(x)
            return torch.nn.functional.gelu(self.se(y))

    class PatchEmbed(torch.nn.Module):
        def __init__(self, cin, cout, use_se):
            super().__init__()
            self.proj = torch.nn.Sequential(
                LargeKernelConv(cin, cout, use_se),
                MobileOneBlock(cout, cout, 1),
            )

        def forward(self, x):
            return self.proj(x)

    class RepCPE(torch.nn.Module):
        def __init__(self, dim):
            super().__init__()
            self.pos_enc = torch.nn.Conv2d(dim, dim, 7, 1, 3, groups=dim,
                                           bias=True)

        def forward(self, x):
            return x + self.pos_enc(x)

    class Stage(torch.nn.Module):
        def __init__(self, si, cin, dim, depth):
            super().__init__()
            self.downsample = (PatchEmbed(cin, dim,
                                          cfg.se_downsamples[si])
                               if si > 0 else torch.nn.Identity())
            self.pos_emb = (RepCPE(dim) if si in cfg.pos_embed_stages
                            else torch.nn.Identity())
            hidden = int(dim * cfg.mlp_ratio)
            mk = cfg.token_mixers[si]
            self.blocks = torch.nn.Sequential(*[
                (AttentionBlock if mk == "attention" else RepMixerBlock)(
                    dim, hidden)
                for _ in range(depth)])

        def forward(self, x):
            return self.blocks(self.pos_emb(self.downsample(x)))

    class Head(torch.nn.Module):
        def __init__(self, cin, out):
            super().__init__()
            self.fc = torch.nn.Linear(cin, out, bias=True)

        def forward(self, x):
            return self.fc(x.mean((2, 3)))

    class Trunk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            d0 = cfg.dims[0]
            self.stem = torch.nn.Sequential(
                MobileOneBlock(3, d0, 3, stride=2),
                MobileOneBlock(d0, d0, 3, stride=2, groups=d0),
                MobileOneBlock(d0, d0, 1),
            )
            chans = (cfg.dims[0],) + cfg.dims
            self.stages = torch.nn.Sequential(*[
                Stage(si, chans[si], cfg.dims[si], cfg.layers[si])
                for si in range(len(cfg.layers))])
            self.final_conv = MobileOneBlock(
                cfg.dims[-1], cfg.final_dim, 3, groups=cfg.dims[-1],
                use_se=True)
            self.head = Head(cfg.final_dim, cfg.embed_dim)

        def forward(self, x):
            return self.head(self.final_conv(self.stages(self.stem(x))))

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.trunk = Trunk()

        def forward(self, x):
            return self.trunk(x)

    torch.manual_seed(0)
    model = Model()
    # randomize BN running stats and layer scales so every folding path is
    # exercised with non-trivial values
    gen = torch.Generator().manual_seed(1)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean = torch.randn(m.num_features, generator=gen) * 0.2
            m.running_var = (
                torch.rand(m.num_features, generator=gen) * 1.5 + 0.3)
            m.weight.data = torch.randn(m.num_features, generator=gen) * 0.3 + 1.0
            m.bias.data = torch.randn(m.num_features, generator=gen) * 0.1
        if isinstance(m, torch.nn.ParameterDict) and "gamma" in m:
            m["gamma"].data = (
                torch.randn_like(m["gamma"]) * 0.3 + 1.0)
    return model.eval()


def test_fastvit_parity(torch_fastvit):
    import torch

    cfg = tiny_cfg()
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_fastvit(
            torch.tensor(images).permute(0, 3, 1, 2)).numpy()

    sd = {"visual." + k: v for k, v in torch_fastvit.state_dict().items()}
    inferred = infer_fastvit_config(sd)
    assert inferred.layers == cfg.layers
    assert inferred.dims == cfg.dims
    assert inferred.token_mixers == cfg.token_mixers
    assert inferred.se_downsamples == cfg.se_downsamples
    assert inferred.pos_embed_stages == cfg.pos_embed_stages
    assert inferred.embed_dim == cfg.embed_dim

    params = convert_fastvit_state_dict(sd, cfg)
    model = FastViTTower(cfg)
    pooled, tokens = model.apply({"params": params}, jnp.asarray(images))
    np.testing.assert_allclose(np.asarray(pooled), ref, rtol=2e-4,
                               atol=2e-4)
    # tokens: final-conv features, 2x2 grid at 64px, 2*dims[-1] channels
    assert tokens.shape == (2, 4, cfg.final_dim)


def test_mobileclip_s_registry_native():
    from clip_embeds.core.config import get_model_config
    from clip_embeds.core.openclip_registry import classify_model

    for name, dims, layers in (
            ("MobileCLIP-S1", (64, 128, 256, 512), (4, 12, 20, 4)),
            ("MobileCLIP-S2", (80, 160, 320, 640), (4, 12, 24, 4))):
        backend, detail = classify_model(name)
        assert backend == "clip", detail
        cfg = get_model_config(name)
        assert cfg.vision.tower == "fastvit"
        assert tuple(cfg.vision.fastvit_dims) == dims
        assert tuple(cfg.vision.fastvit_layers) == layers
        assert cfg.vision.image_size == 256
        assert cfg.embed_dim == 512
        # MobileCLIP-S* text: non-causal 12x512 transformer
        assert cfg.text.width == 512 and cfg.text.no_causal_mask


def test_fastvit_full_model_convert(torch_fastvit):
    """convert_clip_state_dict detects the fastvit stem layout and
    assembles the custom_text ('text.'-prefixed) text tower."""
    import torch

    from clip_embeds.core.config import (
        CLIPConfig,
        TextConfig,
        VisionConfig,
    )
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

    sd = {"visual." + k: v for k, v in torch_fastvit.state_dict().items()}
    sd.update(text_sd)
    sd["logit_scale"] = torch.tensor(2.6593)

    params = convert_clip_state_dict(sd)
    cfg = CLIPConfig(
        embed_dim=24,
        vision=VisionConfig(tower="fastvit", image_size=64,
                            fastvit_layers=(1, 2, 1, 1),
                            fastvit_dims=(16, 32, 64, 128), mlp_ratio=3.0,
                            width=128),
        text=TextConfig(context_length=ctx, vocab_size=vocab, width=d,
                        heads=2, layers=layers, no_causal_mask=True),
    )
    model = CLIP(cfg)
    out = model.apply(
        {"params": params},
        jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, ctx), dtype=jnp.int32),
    )
    assert out["image_features"].shape == (1, 24)
    assert out["text_features"].shape == (1, 24)
