"""InstructBLIP-FlanT5 generative parity vs HF transformers (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.core.torch_convert import convert_instructblip_state_dict
from clip_embeds.models.blip2 import QFormerConfig
from clip_embeds.models.instructblip import InstructBlipConfig, InstructBlipT5
from clip_embeds.models.t5 import T5Config

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def hf_model():
    torch = pytest.importorskip("torch")
    from transformers import (
        InstructBlipConfig as HFConfig,
        InstructBlipForConditionalGeneration,
        InstructBlipQFormerConfig,
        InstructBlipVisionConfig,
        T5Config as HFT5Config,
    )

    cfg = HFConfig(
        vision_config=InstructBlipVisionConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, image_size=32, patch_size=16,
        ).to_dict(),
        qformer_config=InstructBlipQFormerConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, encoder_hidden_size=64, vocab_size=100,
            cross_attention_frequency=2,
        ).to_dict(),
        text_config=HFT5Config(
            vocab_size=256, d_model=48, d_kv=12, d_ff=96, num_layers=2,
            num_heads=4, tie_word_embeddings=False,
            feed_forward_proj="gated-gelu", decoder_start_token_id=0,
        ).to_dict(),
        num_query_tokens=4,
        image_token_index=255,  # HF>=4.5x expands image placeholders in-place
    )
    torch.manual_seed(0)
    model = InstructBlipForConditionalGeneration(cfg).eval()
    with torch.no_grad():
        model.query_tokens.normal_(0, 0.5)
    return model


def _jax_model():
    return InstructBlipT5(
        InstructBlipConfig(
            vision=VisionConfig(image_size=32, patch_size=16, width=64,
                                layers=2, head_width=16, mlp_ratio=2.0),
            qformer=QFormerConfig(
                vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, encoder_hidden_size=64,
            ),
            t5=T5Config(vocab_size=256, d_model=48, d_kv=12, d_ff=96,
                        num_layers=2, num_heads=4),
            num_query_tokens=4,
        ),
        attn_impl="reference",
    )


def test_generative_logit_parity(hf_model):
    import torch

    rng = np.random.default_rng(1)
    b, tq, lt, ta = 2, 6, 7, 3
    pixels = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    q_ids = rng.integers(1, 100, (b, tq)).astype(np.int64)
    t_ids = rng.integers(1, 256, (b, lt)).astype(np.int64)
    labels = rng.integers(1, 256, (b, ta)).astype(np.int64)
    q_mask = np.ones((b, tq), np.int64)
    q_mask[1, -2:] = 0
    t_mask = np.ones((b, lt), np.int64)
    t_mask[1, -1:] = 0

    # HF expects num_query_tokens image placeholders inside input_ids; with
    # them at the front its masked scatter equals our prefix concatenation.
    nq = 4
    hf_t_ids = np.concatenate(
        [np.full((b, nq), 255, np.int64), t_ids], axis=1
    )
    hf_t_mask = np.concatenate([np.ones((b, nq), np.int64), t_mask], axis=1)
    with torch.no_grad():
        hf_out = hf_model(
            pixel_values=torch.tensor(pixels).permute(0, 3, 1, 2),
            qformer_input_ids=torch.tensor(q_ids),
            qformer_attention_mask=torch.tensor(q_mask),
            input_ids=torch.tensor(hf_t_ids),
            attention_mask=torch.tensor(hf_t_mask),
            labels=torch.tensor(labels),
        )
    ref = hf_out.logits.numpy()

    model = _jax_model()
    params = convert_instructblip_state_dict(
        {k: v for k, v in hf_model.state_dict().items()}
    )
    got = model.apply(
        {"params": params},
        jnp.asarray(pixels), jnp.asarray(q_ids.astype(np.int32)),
        jnp.asarray(t_ids.astype(np.int32)),
        jnp.asarray(labels.astype(np.int32)),
        jnp.asarray(q_mask.astype(bool)), jnp.asarray(t_mask.astype(bool)),
    )
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-4)


def test_vqa_scorer_pipeline(hf_model):
    """End-to-end scorer on toy tokenizers: scores finite, in (0, 1], and
    match a direct exp(-mean CE) over the same logits."""
    from clip_embeds.scores.vqa_score import InstructBlipVQAScorer

    model = _jax_model()
    params = convert_instructblip_state_dict(
        {k: v for k, v in hf_model.state_dict().items()}
    )

    def q_tok(text):
        return [1 + (ord(c) % 99) for c in text][:16]

    def t_tok(text):
        return [1 + (ord(c) % 255) for c in text][:16]

    scorer = InstructBlipVQAScorer(
        model, params, qformer_tokenize=q_tok, t5_tokenize=t_tok,
        batch_size=2,
    )
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 255, (40, 48, 3)).astype(np.uint8)
              for _ in range(3)]
    scores = scorer.forward(images, ["a cat", "a dog", "a house"])
    assert scores.shape == (3,)
    assert np.all(np.isfinite(scores))
    assert np.all((scores > 0) & (scores <= 1))
    # same image + same text -> same score regardless of batch position
    scores2 = scorer.forward([images[1]], ["a dog"])
    np.testing.assert_allclose(scores2[0], scores[1], rtol=1e-5)


def test_vision_cache_and_int8(hf_model):
    """forward_image_texts (EVA tower cached per image) matches the per-pair
    forward exactly; the W8A8 T5 trunk (quant_t5='dynamic') runs and stays
    close on the tiny model."""
    from clip_embeds.models.quant import quantize_clip_t5_trunk
    from clip_embeds.scores.vqa_score import InstructBlipVQAScorer

    model = _jax_model()
    params = convert_instructblip_state_dict(
        {k: v for k, v in hf_model.state_dict().items()}
    )

    def q_tok(text):
        return [1 + (ord(c) % 99) for c in text][:16]

    def t_tok(text):
        return [1 + (ord(c) % 255) for c in text][:16]

    scorer = InstructBlipVQAScorer(
        model, params, qformer_tokenize=q_tok, t5_tokenize=t_tok,
        batch_size=2,
    )
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (40, 48, 3)).astype(np.uint8)
    texts = ["a cat", "a dog", "a house"]
    ref = scorer.forward([img] * 3, texts)
    got = scorer.forward_image_texts(img, texts)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    import dataclasses as _dc

    qmodel = _dc.replace(_jax_model(), quant_t5="dynamic")
    qscorer = InstructBlipVQAScorer(
        qmodel, quantize_clip_t5_trunk(params), qformer_tokenize=q_tok,
        t5_tokenize=t_tok, batch_size=2,
    )
    q = qscorer.forward([img] * 3, texts)
    assert np.all((q > 0) & (q <= 1))
    assert np.abs(q - ref).max() < 0.15
