"""Phi-3 decoder parity vs HF transformers (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.phi3 import Phi3ForCausalLM, convert_phi3_state_dict

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def test_phi3_logits_parity():
    torch = pytest.importorskip("torch")
    from transformers import Phi3Config as HFConfig
    from transformers import Phi3ForCausalLM as HFPhi3

    hf_cfg = HFConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        attn_implementation="eager",
        resid_pdrop=0.0, embd_pdrop=0.0, attention_dropout=0.0,
        pad_token_id=0,
    )
    torch.manual_seed(0)
    hf = HFPhi3(hf_cfg).eval()

    cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=64,
    )
    model = Phi3ForCausalLM(cfg, attn_impl="reference")
    params = convert_phi3_state_dict(hf.state_dict(), cfg)

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 12))
    with torch.no_grad():
        expected = hf(torch.from_numpy(ids)).logits.numpy()
    got = np.asarray(model.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, expected, rtol=3e-4, atol=3e-4)


def test_qwen2_logits_parity():
    """Qwen2 (the Qwen2-VL text trunk) = Llama + qkv biases + GQA."""
    torch = pytest.importorskip("torch")
    from transformers import Qwen2Config as HFConfig
    from transformers import Qwen2ForCausalLM as HFQwen2

    hf_cfg = HFConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5, rope_theta=1000000.0,
        attn_implementation="eager", tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    hf = HFQwen2(hf_cfg).eval()

    from clip_embeds.core.torch_convert import convert_llama_state_dict
    from clip_embeds.models.llama import LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2,
        max_position_embeddings=64, rope_theta=1000000.0,
        attention_bias=True,
    )
    model = LlamaForCausalLM(cfg, attn_impl="reference")
    params = convert_llama_state_dict(hf.state_dict())

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 10))
    with torch.no_grad():
        expected = hf(torch.from_numpy(ids)).logits.numpy()
    got = np.asarray(model.apply({"params": params}, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, expected, rtol=3e-4, atol=3e-4)
