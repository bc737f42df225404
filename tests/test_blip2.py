"""BLIP-2 ITM/ITC parity vs HF transformers (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.core.torch_convert import convert_blip2_state_dict
from clip_embeds.models.blip2 import Blip2Config, Blip2ITM, QFormerConfig

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def hf_blip2():
    torch = pytest.importorskip("torch")
    from transformers import (
        Blip2Config as HFConfig,
        Blip2ForImageTextRetrieval,
        Blip2QFormerConfig,
        Blip2VisionConfig,
    )

    cfg = HFConfig(
        vision_config=Blip2VisionConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, image_size=32, patch_size=16,
        ).to_dict(),
        qformer_config=Blip2QFormerConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, encoder_hidden_size=64, vocab_size=100,
            cross_attention_frequency=2, use_qformer_text_input=True,
        ).to_dict(),
        num_query_tokens=4, image_text_hidden_size=16,
    )
    torch.manual_seed(0)
    model = Blip2ForImageTextRetrieval(cfg).eval()
    # non-zero query tokens so cross attention is exercised
    with torch.no_grad():
        model.query_tokens.normal_(0, 0.5)
    return model


def _jax_model():
    return Blip2ITM(
        Blip2Config(
            vision=VisionConfig(image_size=32, patch_size=16, width=64,
                                layers=2, head_width=16, mlp_ratio=2.0),
            qformer=QFormerConfig(
                vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, encoder_hidden_size=64,
            ),
            num_query_tokens=4, image_text_hidden_size=16,
        ),
        attn_impl="reference",
    )


def test_itm_parity(hf_blip2):
    import torch

    model = _jax_model()
    params = convert_blip2_state_dict(hf_blip2.state_dict())

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 90, (2, 9))
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False

    with torch.no_grad():
        expected = hf_blip2(
            pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
            use_image_text_matching_head=True,
        ).logits_per_image.numpy()

    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels),
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        method="itm_logits",
    ))
    np.testing.assert_allclose(got, expected, rtol=3e-4, atol=3e-4)


def test_itc_parity(hf_blip2):
    import torch

    model = _jax_model()
    params = convert_blip2_state_dict(hf_blip2.state_dict())

    rng = np.random.default_rng(1)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 90, (3, 7))
    mask = np.ones((3, 7), bool)

    with torch.no_grad():
        expected = hf_blip2(
            pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
            use_image_text_matching_head=False,
        ).logits_per_image.numpy()

    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels),
        jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
        method="itc_logits",
    ))
    assert got.shape == expected.shape == (2, 3)
    np.testing.assert_allclose(got, expected, rtol=3e-4, atol=3e-4)
