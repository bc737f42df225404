"""LLM2CLIP adapter + converter parity vs a torch replica of the public
adapter layout (the remote-code file is not vendored in the reference; the
converter validates the key structure at load)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.llm2clip import (
    LLM2CLIP,
    LLM2CLIPConfig,
    convert_llm2clip_state_dict,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def tiny_cfg() -> LLM2CLIPConfig:
    return LLM2CLIPConfig(
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
        embed_dim=48, text_embedding_dim=40, adaptor_layers=2,
        expansion_factor=2,
    )


@pytest.fixture(scope="module")
def torch_replica():
    torch = pytest.importorskip("torch")
    from transformers import CLIPVisionConfig, CLIPVisionModel

    class LinearBlock(torch.nn.Module):
        def __init__(self, dim, expansion):
            super().__init__()
            self.fn = torch.nn.Sequential(
                torch.nn.Linear(dim, dim * expansion),
                torch.nn.GELU(),
                torch.nn.Dropout(0.0),
                torch.nn.Linear(dim * expansion, dim),
            )
            self.ln = torch.nn.LayerNorm(dim)

        def forward(self, x):
            return x + self.fn(self.ln(x))

    class Adapter(torch.nn.Module):
        def __init__(self, dim, out_dim, layers, expansion):
            super().__init__()
            self.adaptor = torch.nn.Sequential(
                *[LinearBlock(dim, expansion) for _ in range(layers)],
                torch.nn.LayerNorm(dim),
                torch.nn.Linear(dim, out_dim),
            )

        def forward(self, x):
            return self.adaptor(x)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vision_model = CLIPVisionModel(CLIPVisionConfig(
                hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=256, image_size=32, patch_size=16,
                projection_dim=48,
            )).vision_model
            self.visual_projection = torch.nn.Linear(64, 48, bias=False)
            self.text_adapter = Adapter(40, 48, 2, 2)

        def get_image_features(self, pixels):
            out = self.vision_model(pixels)
            return self.visual_projection(out.pooler_output)

        def get_text_features(self, emb):
            return self.text_adapter(emb)

    torch.manual_seed(0)
    return Model().eval()


def test_llm2clip_parity(torch_replica):
    import torch

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    emb = rng.standard_normal((3, 40)).astype(np.float32)

    with torch.no_grad():
        ref_img = torch_replica.get_image_features(
            torch.tensor(pixels).permute(0, 3, 1, 2)
        ).numpy()
        ref_txt = torch_replica.get_text_features(torch.tensor(emb)).numpy()

    model = LLM2CLIP(tiny_cfg(), attn_impl="reference")
    params = convert_llm2clip_state_dict(
        {k: v for k, v in torch_replica.state_dict().items()}
    )
    got_img = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels), method="get_image_features"
    ))
    got_txt = np.asarray(model.apply(
        {"params": params}, jnp.asarray(emb), method="get_text_features"
    ))
    np.testing.assert_allclose(got_img, ref_img, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got_txt, ref_txt, rtol=3e-4, atol=3e-4)


def test_llm2clip_whatsup_scoring(torch_replica):
    """100*cosine softmax compare (llm2clip-test.py:63-72) runs end-to-end."""
    model = LLM2CLIP(tiny_cfg(), attn_impl="reference")
    params = convert_llm2clip_state_dict(
        {k: v for k, v in torch_replica.state_dict().items()}
    )
    rng = np.random.default_rng(1)
    img, txt = model.apply(
        {"params": params},
        jnp.asarray(rng.standard_normal((1, 32, 32, 3)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((2, 40)).astype(np.float32)),
    )
    probs = np.asarray(jnp.exp(jax_softmax(100.0 * img @ txt.T)))
    assert probs.shape == (1, 2)
    assert abs(probs.sum() - 1) < 1e-5


def jax_softmax(x):
    import jax

    return jax.nn.log_softmax(x, axis=-1)


def test_image_patches_tap(torch_replica):
    import torch

    model = LLM2CLIP(tiny_cfg(), attn_impl="reference")
    params = convert_llm2clip_state_dict(
        {k: v for k, v in torch_replica.state_dict().items()}
    )
    rng = np.random.default_rng(2)
    pixels = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ref = torch_replica.vision_model(
            torch.tensor(pixels).permute(0, 3, 1, 2)
        ).last_hidden_state[:, 1:].numpy()
    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels), method="image_patches"
    ))
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)
