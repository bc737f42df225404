"""LLaVA-Next (AnyRes) parity vs HF transformers + static-shape pack tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.llava import IMAGE_TOKEN_INDEX
from clip_embeds.models.llava_next import (
    LlavaNext,
    LlavaNextConfig,
    anyres_grid_shape,
    anyres_max_features,
    anyres_pack_plan,
    max_num_crops,
    select_best_resolution,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)

PINPOINTS = ((32, 64), (64, 32), (64, 64))


def tiny_cfg() -> LlavaNextConfig:
    return LlavaNextConfig(
        llama=LlamaConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=256,
            rms_norm_eps=1e-6,  # HF LlamaConfig default
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
        grid_pinpoints=PINPOINTS,
    )


def test_select_best_resolution_matches_reference():
    # wide image picks the wide pinpoint, tall picks tall
    assert select_best_resolution((20, 50), PINPOINTS) == (32, 64)
    assert select_best_resolution((50, 20), PINPOINTS) == (64, 32)
    assert select_best_resolution((100, 100), PINPOINTS) == (64, 64)
    assert anyres_grid_shape((20, 50), PINPOINTS, 32) == (1, 2)
    assert max_num_crops(PINPOINTS, 32) == 4


def test_pack_plan_feature_len():
    # g=2, n_base=4; (20,50) -> grid (1,2): rows=2, cols=4
    # unpad with (h=20,w=50): w/h=2.5 > cols/rows=2 -> scale=4/50, new_h=1,
    # pad=(2-1)//2=0 -> all rows kept. len = 4 + 2*(4+1) = 14
    plan = anyres_pack_plan((20, 50), PINPOINTS, 32, 16)
    assert plan.feature_len == 14
    assert plan.valid.sum() == 14
    assert plan.is_newline.sum() == 2  # one newline per kept row
    assert plan.gather.shape == (anyres_max_features(PINPOINTS, 32, 16),)


@pytest.fixture(scope="module")
def hf_model():
    torch = pytest.importorskip("torch")
    from transformers import (
        CLIPVisionConfig,
        LlamaConfig as HFLlamaConfig,
        LlavaNextConfig as HFConfig,
        LlavaNextForConditionalGeneration,
    )

    cfg = HFConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=256, image_size=32, patch_size=16,
            projection_dim=64,
        ).to_dict(),
        text_config=HFLlamaConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=256,
        ).to_dict(),
        image_grid_pinpoints=[list(p) for p in PINPOINTS],
        vision_feature_layer=-2,
        vision_feature_select_strategy="default",
        image_token_index=511,
    )
    torch.manual_seed(0)
    model = LlavaNextForConditionalGeneration(cfg).eval()
    with torch.no_grad():
        model.model.image_newline.normal_(0, 0.5)
    return model


def _jax_params(hf):
    from clip_embeds.core.torch_convert import convert_llava_next_state_dict

    return convert_llava_next_state_dict(
        {k: v for k, v in hf.state_dict().items()}
    )


def _one_image_case(hf_model, orig_hw, seed):
    """Run one image through HF (exact ragged length) and through the static
    JAX pack; compare logits at valid positions."""
    import torch

    rng = np.random.default_rng(seed)
    cfg = tiny_cfg()
    nph, npw = anyres_grid_shape(orig_hw, PINPOINTS, 32)
    n_crops = nph * npw
    plan = anyres_pack_plan(orig_hw, PINPOINTS, 32, 16)

    crops = rng.standard_normal((1 + n_crops, 32, 32, 3)).astype(np.float32)
    # text: [t0 t1 <image> t2 t3]
    text = np.array([3, 5, 7, 11], np.int32)
    hf_ids = np.concatenate([
        text[:2], np.full((plan.feature_len,), 511, np.int64), text[2:]
    ])[None]
    with torch.no_grad():
        hf_out = hf_model(
            input_ids=torch.tensor(hf_ids),
            pixel_values=torch.tensor(crops).permute(0, 3, 1, 2)[None],
            image_sizes=torch.tensor([list(orig_hw)]),
        )
    ref = hf_out.logits[0].numpy()

    model = LlavaNext(cfg, attn_impl="reference")
    params = _jax_params(hf_model)
    f = cfg.max_features
    c_max = 1 + max_num_crops(PINPOINTS, 32)
    pixels = np.zeros((1, c_max, 32, 32, 3), np.float32)
    pixels[0, : 1 + n_crops] = crops
    input_ids = np.array(
        [[3, 5, IMAGE_TOKEN_INDEX, 7, 11]], np.int32
    )
    got = model.apply(
        {"params": params},
        jnp.asarray(input_ids), jnp.asarray(pixels),
        jnp.asarray(plan.gather[None]), jnp.asarray(plan.is_newline[None]),
        jnp.asarray(plan.valid[None]),
    )
    got = np.asarray(got)[0]
    # valid rows of the static layout, in order == HF's packed rows
    mask = np.concatenate([
        np.ones(2, bool), plan.valid, np.ones(2, bool)
    ])
    np.testing.assert_allclose(got[mask], ref, rtol=3e-4, atol=3e-4)


def test_hf_parity_wide(hf_model):
    _one_image_case(hf_model, (20, 50), seed=1)


def test_hf_parity_tall_full_grid(hf_model):
    _one_image_case(hf_model, (100, 100), seed=2)


def test_batched_matches_single(hf_model):
    """Two images with different grids in one padded batch score identically
    to their single runs (the masked-holes design is position-exact)."""
    cfg = tiny_cfg()
    model = LlavaNext(cfg, attn_impl="reference")
    params = _jax_params(hf_model)
    rng = np.random.default_rng(3)
    c_max = 1 + max_num_crops(PINPOINTS, 32)
    f = cfg.max_features

    cases = [(20, 50), (100, 100)]
    pixels = np.zeros((2, c_max, 32, 32, 3), np.float32)
    gather = np.zeros((2, f), np.int32)
    newline = np.zeros((2, f), bool)
    valid = np.zeros((2, f), bool)
    for i, hw in enumerate(cases):
        nph, npw = anyres_grid_shape(hw, PINPOINTS, 32)
        pixels[i, : 1 + nph * npw] = rng.standard_normal(
            (1 + nph * npw, 32, 32, 3)
        ).astype(np.float32)
        plan = anyres_pack_plan(hw, PINPOINTS, 32, 16)
        gather[i], newline[i], valid[i] = plan.gather, plan.is_newline, plan.valid
    ids = np.array([[3, 5, IMAGE_TOKEN_INDEX, 7, 11]] * 2, np.int32)

    batched = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(pixels),
        jnp.asarray(gather), jnp.asarray(newline), jnp.asarray(valid),
    ))
    for i in range(2):
        single = np.asarray(model.apply(
            {"params": params}, jnp.asarray(ids[i : i + 1]),
            jnp.asarray(pixels[i : i + 1]), jnp.asarray(gather[i : i + 1]),
            jnp.asarray(newline[i : i + 1]), jnp.asarray(valid[i : i + 1]),
        ))[0]
        keep = np.concatenate([np.ones(2, bool), valid[i], np.ones(2, bool)])
        np.testing.assert_allclose(
            batched[i][keep], single[keep], rtol=1e-5, atol=1e-5
        )


def test_embed_last_token_pools_real_last_token(hf_model):
    cfg = tiny_cfg()
    model = LlavaNext(cfg, attn_impl="reference")
    params = _jax_params(hf_model)
    rng = np.random.default_rng(4)
    c_max = 1 + max_num_crops(PINPOINTS, 32)
    plan = anyres_pack_plan((20, 50), PINPOINTS, 32, 16)
    pixels = np.zeros((1, c_max, 32, 32, 3), np.float32)
    pixels[0, :3] = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    ids = np.array([[3, 5, IMAGE_TOKEN_INDEX, 7, 11]], np.int32)
    emb = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(pixels),
        jnp.asarray(plan.gather[None]), jnp.asarray(plan.is_newline[None]),
        jnp.asarray(plan.valid[None]), method="embed_last_token",
    ))
    assert emb.shape == (1, 64)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, rtol=1e-5)


def test_process_anyres_image_shapes():
    from clip_embeds.core.constants import (
        OPENAI_DATASET_MEAN,
        OPENAI_DATASET_STD,
    )
    from clip_embeds.models.llava_next import process_anyres_image

    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (20, 50, 3)).astype(np.uint8)
    crops, hw = process_anyres_image(
        img, 32, PINPOINTS, OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
    )
    assert hw == (20, 50)
    assert crops.shape == (1 + 4, 32, 32, 3)
    # (20,50) -> best (32,64) -> 2 spatial crops; crops 3,4 are zero padding
    assert np.allclose(crops[3:], 0)
    assert not np.allclose(crops[:3], 0)
