"""Phi-3-V HD image embedding parity vs the reference Phi3ImageEmbedding
(loaded from /root/reference as a runtime oracle, with a 2-layer width-1024
CLIP patched in so the hardcoded 576/1024 asserts hold), plus host
preprocessing parity vs the reference image processor math."""

import importlib.util
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.phi3_v import (
    Phi3V,
    Phi3VConfig,
    Phi3VImageEmbedding,
    bicubic_no_antialias,
    convert_phi3v_image_embedding_state_dict,
    hd_transform_grid,
    phi3v_num_image_tokens,
    phi3v_process_image,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

REF = "/root/reference/VLM2Vec/src/vlm_backbone/phi3_v/image_embedding_phi3_v.py"


def _vision_cfg() -> VisionConfig:
    return VisionConfig(image_size=336, patch_size=14, width=1024, layers=2,
                        head_width=128, mlp_ratio=0.25)


def _tiny_cfg() -> Phi3VConfig:
    return Phi3VConfig(
        text=LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                         num_layers=2, num_heads=4,
                         max_position_embeddings=2048, rms_norm_eps=1e-5),
        vision=_vision_cfg(),
    )


@pytest.fixture(scope="module")
def ref_embedding():
    torch = pytest.importorskip("torch")
    from transformers import CLIPVisionConfig, PretrainedConfig

    spec = importlib.util.spec_from_file_location("ref_phi3v_embed", REF)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ref_phi3v_embed"] = mod
    spec.loader.exec_module(mod)
    # shrink the hardcoded ViT-L to 2 layers (width/patch stay 1024/14 so the
    # reference's 576/1024 asserts hold)
    mod.CLIP_VIT_LARGE_PATCH14_336_CONFIG = CLIPVisionConfig(
        hidden_size=1024, num_hidden_layers=2, num_attention_heads=8,
        intermediate_size=256, image_size=336, patch_size=14,
        hidden_act="quick_gelu", layer_norm_eps=1e-5, projection_dim=768,
    )

    cfg = PretrainedConfig()
    cfg.hidden_size = 64
    cfg.vocab_size = 512
    cfg._attn_implementation = "eager"
    cfg.img_processor = {
        "name": "clip_vision_model",
        "model_name": "openai/clip-vit-large-patch14-336",
        "image_dim_out": 1024,
        "num_img_tokens": 144,
    }
    torch.manual_seed(0)
    wte = torch.nn.Embedding(512, 64)
    emb = mod.Phi3ImageEmbedding(
        cfg, wte=wte, use_hd_transform=True, with_learnable_separator=True,
        hd_transform_order="sub_glb", projection_cls="mlp",
    ).eval()
    with torch.no_grad():
        emb.glb_GN.normal_(0, 0.5)
        emb.sub_GN.normal_(0, 0.5)
    return emb


def test_hd_feature_transform_parity(ref_embedding):
    import torch

    rng = np.random.default_rng(0)
    h_crop, w_crop = 1, 2
    n = 1 + h_crop * w_crop
    pixels = rng.standard_normal((1, n, 336, 336, 3)).astype(np.float32)

    with torch.no_grad():
        feats = ref_embedding.get_img_features(
            torch.tensor(pixels[0]).permute(0, 3, 1, 2)
        ).reshape(1, n, -1, 1024)
        ref = ref_embedding.hd_feature_transform(
            feats, torch.tensor([[h_crop * 336, w_crop * 336]])
        ).numpy()

    model = Phi3VImageEmbedding(_tiny_cfg(), attn_impl="reference")
    params = convert_phi3v_image_embedding_state_dict(
        {k: v for k, v in ref_embedding.state_dict().items()}
    )
    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels), h_crop, w_crop
    ))[0]
    assert got.shape[0] == phi3v_num_image_tokens(h_crop, w_crop)
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


def test_full_model_scatter(ref_embedding):
    """Scatter at negative ids matches the reference index_put semantics and
    the embedding feeds the trunk (finite logits, correct shapes)."""
    cfg = _tiny_cfg()
    model = Phi3V(cfg, attn_impl="reference")
    rng = np.random.default_rng(1)
    h_crop, w_crop = 1, 1
    s = phi3v_num_image_tokens(h_crop, w_crop)
    pixels = rng.standard_normal((1, 2, 336, 336, 3)).astype(np.float32)
    ids = np.concatenate([
        [5, 7], np.full((s,), -1, np.int64), [11, 13]
    ])[None].astype(np.int32)
    vision_params = convert_phi3v_image_embedding_state_dict(
        {k: v for k, v in ref_embedding.state_dict().items()}
    )
    # init all params, then splice in the converted vision weights
    full = model.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(pixels),
        h_crop, w_crop,
    )["params"]
    full["vision_embed"] = vision_params
    logits = np.asarray(model.apply(
        {"params": full}, jnp.asarray(ids), jnp.asarray(pixels),
        h_crop, w_crop,
    ))
    assert logits.shape == (1, 4 + s, 512)
    assert np.all(np.isfinite(logits))
    emb = np.asarray(model.apply(
        {"params": full}, jnp.asarray(ids), jnp.asarray(pixels),
        h_crop, w_crop, method="embed_last_token",
    ))
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


def test_bicubic_no_antialias_matches_torch():
    torch = pytest.importorskip("torch")

    rng = np.random.default_rng(2)
    arr = rng.standard_normal((50, 70, 3)).astype(np.float32)
    ref = torch.nn.functional.interpolate(
        torch.tensor(arr).permute(2, 0, 1)[None], size=(20, 30),
        mode="bicubic", align_corners=False,
    )[0].permute(1, 2, 0).numpy()
    got = bicubic_no_antialias(arr, 20, 30)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_hd_transform_grid_and_process():
    # wide 800x500 image: scale search with hd_num=4
    h_crop, w_crop = hd_transform_grid(800, 500, hd_num=4)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (500, 800, 3)).astype(np.uint8)
    crops, grid = phi3v_process_image(img, hd_num=4, max_crops=4)
    assert grid == (h_crop, w_crop)
    assert crops.shape == (5, 336, 336, 3)
    n_used = 1 + h_crop * w_crop
    assert not np.allclose(crops[:n_used], 0)
    if n_used < 5:
        assert np.allclose(crops[n_used:], 0)
    # tall image transposes through the HD transform
    h2, w2 = hd_transform_grid(500, 800, hd_num=4)
    assert (h2, w2) == (w_crop, h_crop)
