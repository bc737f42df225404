"""Qwen2-VL parity vs HF transformers: vision tower (2D RoPE + merger),
M-RoPE position ids, and full multimodal logits (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.qwen2_vl import (
    Qwen2VL,
    Qwen2VLConfig,
    Qwen2VLVisionConfig,
    Qwen2VisionTower,
    get_rope_index,
    image_to_patches,
    smart_resize,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

IMAGE_TOKEN, VIDEO_TOKEN, VISION_START = 500, 501, 502


def tiny_cfg() -> Qwen2VLConfig:
    return Qwen2VLConfig(
        text=LlamaConfig(
            vocab_size=512, hidden_size=48, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=128, rms_norm_eps=1e-5,  # HF tiny default
            attention_bias=True, mrope_section=(2, 2, 2),
        ),
        vision=Qwen2VLVisionConfig(
            depth=2, embed_dim=32, hidden_size=48, mlp_ratio=2.0,
            num_heads=2, patch_size=4, spatial_merge_size=2,
            temporal_patch_size=2,
        ),
        image_token_id=IMAGE_TOKEN, video_token_id=VIDEO_TOKEN,
        vision_start_token_id=VISION_START,
    )


@pytest.fixture(scope="module")
def hf_model():
    torch = pytest.importorskip("torch")
    from transformers import Qwen2VLConfig as HFConfig
    from transformers import Qwen2VLForConditionalGeneration

    cfg = HFConfig(
        vision_config=dict(depth=2, embed_dim=32, hidden_size=48, mlp_ratio=2,
                           num_heads=2, in_channels=3, patch_size=4,
                           spatial_merge_size=2, temporal_patch_size=2),
        hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
        rope_theta=10000.0,
        rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
        image_token_id=IMAGE_TOKEN, video_token_id=VIDEO_TOKEN,
        vision_start_token_id=VISION_START,
    )
    torch.manual_seed(0)
    return Qwen2VLForConditionalGeneration(cfg).eval()


def _params(hf):
    from clip_embeds.core.torch_convert import convert_qwen2_vl_state_dict

    return convert_qwen2_vl_state_dict(
        {k: v for k, v in hf.state_dict().items()}
    )


def test_vision_tower_parity(hf_model):
    import torch

    rng = np.random.default_rng(0)
    grid = (1, 4, 6)
    l = grid[0] * grid[1] * grid[2]
    patch_dim = 3 * 2 * 4 * 4
    patches = rng.standard_normal((l, patch_dim)).astype(np.float32)

    with torch.no_grad():
        ref = hf_model.model.visual(
            torch.tensor(patches), torch.tensor([list(grid)])
        ).numpy()

    cfg = tiny_cfg()
    tower = Qwen2VisionTower(cfg.vision)
    params = _params(hf_model)["visual"]
    got = np.asarray(tower.apply(
        {"params": params}, jnp.asarray(patches[None]), grid
    ))[0]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_vision_tower_video_frames(hf_model):
    """t=2 grid: attention restricted per frame must still match HF."""
    import torch

    rng = np.random.default_rng(1)
    grid = (2, 4, 4)
    l = grid[0] * grid[1] * grid[2]
    patches = rng.standard_normal((l, 96)).astype(np.float32)
    with torch.no_grad():
        ref = hf_model.model.visual(
            torch.tensor(patches), torch.tensor([list(grid)])
        ).numpy()
    tower = Qwen2VisionTower(tiny_cfg().vision)
    got = np.asarray(tower.apply(
        {"params": _params(hf_model)["visual"]},
        jnp.asarray(patches[None]), grid,
    ))[0]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _build_sequence(grid):
    """[text, vision_start, image tokens, text] input ids."""
    m = 2
    lv = (grid[0] * grid[1] * grid[2]) // (m * m)
    ids = [3, 5, VISION_START] + [IMAGE_TOKEN] * lv + [7, 11, 13]
    return np.asarray([ids], np.int64)


def test_rope_index_parity(hf_model):
    import torch

    grid = (1, 4, 6)
    ids = _build_sequence(grid)
    mask = np.ones_like(ids)
    ref, _ = hf_model.model.get_rope_index(
        torch.tensor(ids), torch.tensor([list(grid)]), None,
        torch.tensor(mask),
    )
    got = get_rope_index(ids, [grid], mask, tiny_cfg())
    np.testing.assert_array_equal(got, ref.numpy().transpose(1, 0, 2))


def test_full_logits_parity(hf_model):
    import torch

    rng = np.random.default_rng(2)
    grid = (1, 4, 6)
    l = grid[0] * grid[1] * grid[2]
    patches = rng.standard_normal((l, 96)).astype(np.float32)
    ids = _build_sequence(grid)

    with torch.no_grad():
        ref = hf_model(
            input_ids=torch.tensor(ids),
            pixel_values=torch.tensor(patches),
            image_grid_thw=torch.tensor([list(grid)]),
        ).logits.numpy()

    cfg = tiny_cfg()
    model = Qwen2VL(cfg, attn_impl="reference")
    positions = get_rope_index(ids, [grid], None, cfg)
    got = np.asarray(model.apply(
        {"params": _params(hf_model)},
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(patches[None]), grid,
        None, jnp.asarray(positions),
    ))
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


def test_embed_last_token(hf_model):
    rng = np.random.default_rng(3)
    grid = (1, 4, 4)
    patches = rng.standard_normal((16, 96)).astype(np.float32)
    ids = _build_sequence(grid)
    cfg = tiny_cfg()
    model = Qwen2VL(cfg, attn_impl="reference")
    positions = get_rope_index(ids, [grid], None, cfg)
    emb = np.asarray(model.apply(
        {"params": _params(hf_model)},
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(patches[None]), grid,
        None, jnp.asarray(positions), method="embed_last_token",
    ))
    assert emb.shape == (1, 48)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


def test_image_to_patches_matches_hf_processor():
    """Host patch flattening matches the HF image processor layout."""
    torch = pytest.importorskip("torch")
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import (
        Qwen2VLImageProcessor,
    )

    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (24, 16, 3)).astype(np.uint8)
    proc = Qwen2VLImageProcessor(
        patch_size=4, merge_size=2, temporal_patch_size=2,
        min_pixels=8 * 8, max_pixels=64 * 64,
    )
    out = proc(images=[img], return_tensors="np")
    ref, ref_grid = out["pixel_values"], out["image_grid_thw"][0]

    # replicate: smart_resize + normalize (HF OPENAI_CLIP stats by default)
    from clip_embeds.core.constants import (
        OPENAI_DATASET_MEAN,
        OPENAI_DATASET_STD,
    )
    from PIL import Image

    h_bar, w_bar = smart_resize(24, 16, factor=8, min_pixels=64,
                                max_pixels=4096)
    resized = np.asarray(
        Image.fromarray(img).resize((w_bar, h_bar), Image.BICUBIC),
        np.float32,
    ) / 255.0
    norm = (resized - OPENAI_DATASET_MEAN) / OPENAI_DATASET_STD
    flat, grid = image_to_patches(
        norm.transpose(2, 0, 1), tiny_cfg().vision
    )
    assert tuple(ref_grid) == grid
    np.testing.assert_allclose(flat, ref, rtol=2e-2, atol=2e-2)
