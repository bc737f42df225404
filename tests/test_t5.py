"""T5 encoder-decoder parity vs HF transformers (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.torch_convert import convert_t5_state_dict
from clip_embeds.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
    shift_right,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def hf_t5():
    torch = pytest.importorskip("torch")
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration as HFT5

    cfg = HFT5Config(
        vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
        num_heads=4, relative_attention_num_buckets=32,
        feed_forward_proj="gated-gelu", tie_word_embeddings=False,
        decoder_start_token_id=0,
    )
    torch.manual_seed(0)
    return HFT5(cfg).eval()


def _jax_model():
    return T5ForConditionalGeneration(
        T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
                 num_heads=4)
    )


def test_t5_logits_parity(hf_t5):
    import torch

    model = _jax_model()
    params = convert_t5_state_dict(hf_t5.state_dict())

    rng = np.random.default_rng(0)
    enc_ids = rng.integers(3, 250, (2, 11))
    dec_ids = rng.integers(3, 250, (2, 7))
    enc_mask = np.ones((2, 11), bool)
    enc_mask[1, 8:] = False
    dec_mask = np.ones((2, 7), bool)
    dec_mask[1, 5:] = False

    with torch.no_grad():
        expected = hf_t5(
            input_ids=torch.from_numpy(enc_ids),
            attention_mask=torch.from_numpy(enc_mask.astype(np.int64)),
            decoder_input_ids=torch.from_numpy(dec_ids),
            decoder_attention_mask=torch.from_numpy(dec_mask.astype(np.int64)),
        ).logits.numpy()

    got = np.asarray(model.apply(
        {"params": params},
        jnp.asarray(enc_ids, jnp.int32),
        jnp.asarray(dec_ids, jnp.int32),
        attention_mask=jnp.asarray(enc_mask),
        decoder_attention_mask=jnp.asarray(dec_mask),
    ))
    assert got.shape == expected.shape
    # compare only fully-valid rows/cols (padded positions are unconstrained)
    np.testing.assert_allclose(got[0], expected[0], rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(
        got[1, :5], expected[1, :5], rtol=3e-4, atol=3e-4
    )


def test_shift_right():
    labels = jnp.asarray([[5, 6, -100]], jnp.int32)
    out = shift_right(labels, decoder_start_token_id=0, pad_id=0)
    np.testing.assert_array_equal(np.asarray(out), [[0, 5, 6]])
