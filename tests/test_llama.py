"""Llama decoder parity vs HF transformers (tiny random config, CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.core.torch_convert import convert_llama_state_dict
from clip_embeds.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def hf_pair():
    torch = pytest.importorskip("torch")
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM as HFLlama

    hf_cfg = HFConfig(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=4,
        max_position_embeddings=64,
        rms_norm_eps=1e-5,
        tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf = HFLlama(hf_cfg).eval()
    cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=64,
    )
    model = LlamaForCausalLM(cfg, attn_impl="reference")
    params = convert_llama_state_dict(hf.state_dict())
    return hf, model, params


def test_logits_parity(hf_pair):
    import torch

    hf, model, params = hf_pair
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, (2, 12))

    with torch.no_grad():
        expected = hf(torch.from_numpy(ids)).logits.numpy()

    got = model.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(np.asarray(got), expected, rtol=2e-4, atol=2e-4)


def test_padding_mask_parity(hf_pair):
    """Right-padded batch with attention_mask must match HF."""
    import torch

    hf, model, params = hf_pair
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 10))
    mask = np.ones((2, 10), bool)
    ids[1, 7:] = 0
    mask[1, 7:] = False

    with torch.no_grad():
        expected = hf(
            torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
        ).logits.numpy()

    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids, jnp.int32),
        attention_mask=jnp.asarray(mask),
    ))
    # compare only valid positions (padded outputs are unconstrained)
    np.testing.assert_allclose(got[0], expected[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        got[1, :7], expected[1, :7], rtol=2e-4, atol=2e-4
    )


def test_gqa_shapes():
    import jax

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_layers=1, num_heads=4, num_kv_heads=2,
    )
    model = LlamaForCausalLM(cfg, attn_impl="reference")
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids)["params"]
    out = model.apply({"params": params}, ids)
    assert out.shape == (1, 8, 128)


def test_llama_tensor_parallel_sharding():
    """TP PartitionSpecs cover the Llama trunk (column qkv/gate/up, row
    o/down, one all-reduce per block); sharded forward == replicated."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from clip_embeds.models.llama import LlamaConfig, LlamaForCausalLM
    from clip_embeds.parallel.sharding_rules import (
        clip_param_specs,
        shard_params,
    )

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=8, num_kv_heads=2,
        max_position_embeddings=32,
    )
    model = LlamaForCausalLM(cfg, attn_impl="reference")
    ids = jnp.zeros((2, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids)["params"]

    specs = clip_param_specs(params)
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    by_name = {"/".join(getattr(p, "key", str(p)) for p in path): s
               for path, s in flat}
    assert any(k.endswith("q_proj/kernel") and s == P(None, "model")
               for k, s in by_name.items())
    assert any(k.endswith("o_proj/kernel") and s == P("model", None)
               for k, s in by_name.items())
    assert any(k.endswith("down_proj/kernel") and s == P("model", None)
               for k, s in by_name.items())

    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    want = np.asarray(model.apply({"params": params}, ids))
    sharded = shard_params(mesh, params)
    # kv width 2*8=16 divides model axis 4; q width 64 too
    with mesh:
        got = np.asarray(
            jax.jit(lambda p, i: model.apply({"params": p}, i))(sharded, ids)
        )
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
