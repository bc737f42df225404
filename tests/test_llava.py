"""LLaVA stack parity vs HF transformers + VQAScore pipeline tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.torch_convert import convert_llava_state_dict
from clip_embeds.core.config import VisionConfig
from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.llava import (
    IMAGE_TOKEN_INDEX,
    Llava,
    LlavaConfig,
    expand_like_tokens,
    splice_positions,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def tiny_cfg():
    return LlavaConfig(
        llama=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=128,
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )

HF_IMAGE_TOKEN = 99


@pytest.fixture(scope="module")
def hf_llava():
    torch = pytest.importorskip("torch")
    from transformers import CLIPVisionConfig, LlamaConfig as HFLlamaConfig
    from transformers import LlavaConfig as HFLlavaConfig
    from transformers import LlavaForConditionalGeneration

    vision_cfg = CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=16,
        hidden_act="quick_gelu",
    )
    text_cfg = HFLlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        attn_implementation="eager",
    )
    cfg = HFLlavaConfig(
        vision_config=vision_cfg, text_config=text_cfg,
        image_token_index=HF_IMAGE_TOKEN,
        vision_feature_layer=-2, vision_feature_select_strategy="default",
        projector_hidden_act="gelu",
    )
    torch.manual_seed(0)
    model = LlavaForConditionalGeneration(cfg).eval()
    return model


def test_splice_positions():
    ids = jnp.asarray([[1, 2, IMAGE_TOKEN_INDEX, 3, 4]], jnp.int32)
    pos, is_img, text_gather, img_gather = splice_positions(ids, 3)
    assert int(pos[0]) == 2
    # final length 5 - 1 + 3 = 7: [t0, t1, i0, i1, i2, t3, t4]
    np.testing.assert_array_equal(
        np.asarray(is_img[0]), [False, False, True, True, True, False, False]
    )
    np.testing.assert_array_equal(np.asarray(text_gather[0, 5:]), [3, 4])

    labels = jnp.asarray([[10, 11, -100, 12, 13]], jnp.int32)
    out = expand_like_tokens(labels, ids, 3, -100)
    np.testing.assert_array_equal(
        np.asarray(out[0]), [10, 11, -100, -100, -100, 12, 13]
    )


def test_llava_logits_parity(hf_llava):
    import torch

    cfg = tiny_cfg()
    model = Llava(cfg, attn_impl="reference")
    params = convert_llava_state_dict(hf_llava.state_dict())

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    n_image = cfg.n_image_tokens  # 4 patches (32/16)^2
    pre = [1, 5, 6]
    post = [7, 8, 9, 10]

    ids_mine = np.asarray([pre + [IMAGE_TOKEN_INDEX] + post], np.int32)
    ids_hf = np.asarray([pre + [HF_IMAGE_TOKEN] * n_image + post], np.int64)

    with torch.no_grad():
        expected = hf_llava(
            input_ids=torch.from_numpy(ids_hf),
            pixel_values=torch.from_numpy(
                pixels.transpose(0, 3, 1, 2)
            ),
        ).logits.numpy()

    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids_mine), jnp.asarray(pixels)
    ))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=3e-4, atol=3e-4)


def test_vqa_scorer_pipeline(hf_llava):
    """VQAScore end-to-end with a toy word tokenizer on the tiny model."""
    from PIL import Image

    from clip_embeds.scores.vqa_score import VQAScorer

    cfg = tiny_cfg()
    model = Llava(cfg, attn_impl="reference")
    params = convert_llava_state_dict(hf_llava.state_dict())

    def toy_tokenize(text):
        # deterministic word-hash tokenizer with BOS=1
        return [1] + [2 + (hash(w) % 200) for w in text.split()]

    scorer = VQAScorer(
        model, params, toy_tokenize, bos_token_id=1, pad_token_id=0,
        batch_size=2, pad_to_multiple=8,
    )
    rng = np.random.default_rng(1)
    imgs = [
        Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8))
        for _ in range(3)
    ]
    scores = scorer.forward(imgs, ["a cat", "a dog", "a house"])
    assert scores.shape == (3,)
    assert np.all(scores > 0) and np.all(scores <= 1)


def test_embed_last_token(hf_llava):
    cfg = tiny_cfg()
    model = Llava(cfg, attn_impl="reference")
    params = convert_llava_state_dict(hf_llava.state_dict())

    ids = np.asarray([
        [1, 5, IMAGE_TOKEN_INDEX, 7, 8],
        [1, 6, IMAGE_TOKEN_INDEX, 9, 0],   # right-padded
    ], np.int32)
    mask = np.asarray([[1, 1, 1, 1, 1], [1, 1, 1, 1, 0]], np.int32)
    pixels = np.zeros((2, 32, 32, 3), np.float32)

    reps = model.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(pixels),
        jnp.asarray(mask), method="embed_last_token",
    )
    assert reps.shape == (2, cfg.llama.hidden_size)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(reps), axis=-1), 1.0, rtol=1e-5
    )
    # text-only path
    reps_t = model.apply(
        {"params": params}, jnp.asarray(np.abs(ids)), None,
        jnp.asarray(mask), method="embed_last_token",
    )
    assert reps_t.shape == (2, cfg.llama.hidden_size)
