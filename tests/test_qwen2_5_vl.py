"""Qwen2.5-VL parity vs HF transformers: window-attention vision tower
(reordered merge-groups, ragged window padding, full-attention layers),
and full multimodal logits (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.qwen2_vl import (
    Qwen25VisionTower,
    Qwen25VL,
    Qwen25VLConfig,
    Qwen25VLVisionConfig,
    _window_plan,
    get_rope_index,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

IMAGE_TOKEN, VIDEO_TOKEN, VISION_START = 500, 501, 502

# vit_merger_window_size = 16 / 2 / 4 = 2 cells per window side
VIS = dict(
    depth=3, embed_dim=32, intermediate_size=64, hidden_size=48,
    num_heads=2, patch_size=4, spatial_merge_size=2, temporal_patch_size=2,
    window_size=16, fullatt_block_indexes=(1,),
)


def tiny_cfg() -> Qwen25VLConfig:
    return Qwen25VLConfig(
        text=LlamaConfig(
            vocab_size=512, hidden_size=48, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2,
            max_position_embeddings=128, rms_norm_eps=1e-5,
            attention_bias=True, mrope_section=(2, 2, 2),
        ),
        vision=Qwen25VLVisionConfig(**VIS),
        image_token_id=IMAGE_TOKEN, video_token_id=VIDEO_TOKEN,
        vision_start_token_id=VISION_START,
    )


@pytest.fixture(scope="module")
def hf_model():
    torch = pytest.importorskip("torch")
    from transformers import Qwen2_5_VLConfig as HFConfig
    from transformers import Qwen2_5_VLForConditionalGeneration

    cfg = HFConfig(
        vision_config=dict(
            depth=3, hidden_size=32, intermediate_size=64, out_hidden_size=48,
            num_heads=2, in_channels=3, patch_size=4, spatial_merge_size=2,
            temporal_patch_size=2, window_size=16, fullatt_block_indexes=[1],
            hidden_act="silu",
        ),
        hidden_size=48, intermediate_size=96, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
        rope_theta=10000.0,
        rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
        image_token_id=IMAGE_TOKEN, video_token_id=VIDEO_TOKEN,
        vision_start_token_id=VISION_START,
    )
    torch.manual_seed(0)
    return Qwen2_5_VLForConditionalGeneration(cfg).eval()


def _params(hf):
    from clip_embeds.core.torch_convert import (
        convert_qwen2_5_vl_state_dict,
    )

    return convert_qwen2_5_vl_state_dict(dict(hf.state_dict()))


def test_window_plan_matches_hf(hf_model):
    """perm == HF get_window_index; segment boundaries == cu_window_seqlens."""
    import torch

    for grid in [(1, 8, 12), (1, 6, 10), (2, 4, 6)]:
        ref_idx, ref_cu = hf_model.model.visual.get_window_index(
            torch.tensor([list(grid)])
        )
        perm, win_id = _window_plan(grid, tiny_cfg().vision)
        np.testing.assert_array_equal(perm, ref_idx.numpy())
        # boundaries where win_id changes (in tokens) must equal the unique
        # consecutive cu_window_seqlens the HF forward derives
        m2 = 4
        cu = np.unique(np.asarray(ref_cu))
        starts = np.flatnonzero(np.diff(win_id, prepend=-1)) * m2
        np.testing.assert_array_equal(starts, cu[:-1])


@pytest.mark.parametrize(
    "grid", [(1, 8, 12), (1, 6, 10), (2, 4, 6)],
    ids=["aligned", "ragged-pad", "video-2frame"],
)
def test_vision_tower_parity(hf_model, grid):
    import torch

    rng = np.random.default_rng(0)
    l = grid[0] * grid[1] * grid[2]
    patch_dim = 3 * 2 * 4 * 4
    patches = rng.standard_normal((l, patch_dim)).astype(np.float32)

    with torch.no_grad():
        ref = hf_model.model.visual(
            torch.tensor(patches), torch.tensor([list(grid)])
        ).numpy()

    tower = Qwen25VisionTower(tiny_cfg().vision)
    got = np.asarray(tower.apply(
        {"params": _params(hf_model)["visual"]},
        jnp.asarray(patches[None]), grid,
    ))[0]
    np.testing.assert_allclose(got, ref, rtol=3e-4, atol=3e-4)


def _build_sequence(grid):
    lv = (grid[0] * grid[1] * grid[2]) // 4
    ids = [3, 5, VISION_START] + [IMAGE_TOKEN] * lv + [7, 11, 13]
    return np.asarray([ids], np.int64)


def test_full_logits_parity(hf_model):
    import torch

    rng = np.random.default_rng(2)
    grid = (1, 6, 10)
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
    model = Qwen25VL(cfg, attn_impl="reference")
    # Qwen2.5's get_rope_index adds video second-per-grid handling but is
    # identical for images; reuse the Qwen2-VL host helper
    positions = get_rope_index(ids, [grid], None, cfg)
    got = np.asarray(model.apply(
        {"params": _params(hf_model)},
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(patches[None]), grid,
        None, jnp.asarray(positions),
    ))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)


def test_embed_last_token(hf_model):
    rng = np.random.default_rng(3)
    grid = (1, 4, 4)
    patches = rng.standard_normal((16, 96)).astype(np.float32)
    ids = _build_sequence(grid)
    cfg = tiny_cfg()
    model = Qwen25VL(cfg, attn_impl="reference")
    positions = get_rope_index(ids, [grid], None, cfg)
    emb = np.asarray(model.apply(
        {"params": _params(hf_model)},
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(patches[None]), grid,
        None, jnp.asarray(positions), method="embed_last_token",
    ))
    assert emb.shape == (1, 48)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)
