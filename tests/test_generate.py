"""KV-cache greedy generation vs HF greedy generate (tiny Llama)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.torch_convert import convert_llama_state_dict
from clip_embeds.models.generate import greedy_generate
from clip_embeds.models.llama import LlamaConfig, LlamaForCausalLM

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def pair():
    torch = pytest.importorskip("torch")
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM as HFLlama

    hf_cfg = HFConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf = HFLlama(hf_cfg).eval()
    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, max_position_embeddings=64,
    )
    model = LlamaForCausalLM(cfg, attn_impl="reference")
    params = convert_llama_state_dict(hf.state_dict())
    return hf, model, params


def test_cached_forward_matches_full(pair):
    """Decode-mode chunked forward == full forward (cache correctness)."""
    _, model, params = pair
    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(0, 128, (2, 10)), jnp.int32)

    full = model.apply({"params": params}, ids)

    # chunked: prefill 6 tokens, then 4 single steps
    from clip_embeds.models.generate import init_cache

    cache = init_cache(model, 2)
    embeds = model.apply({"params": params}, ids[:, :6], method="embed")
    pos = jnp.broadcast_to(jnp.arange(6)[None], (2, 6))
    h, upd = model.apply(
        {"params": params, "cache": cache}, embeds, None, pos, True,
        method="trunk", mutable=["cache"],
    )
    outs = [model.apply({"params": params}, h, method="logits")]
    cache = upd["cache"]
    for t in range(6, 10):
        e = model.apply({"params": params}, ids[:, t : t + 1], method="embed")
        pos = jnp.full((2, 1), t, jnp.int32)
        h, upd = model.apply(
            {"params": params, "cache": cache}, e, None, pos, True,
            method="trunk", mutable=["cache"],
        )
        cache = upd["cache"]
        outs.append(model.apply({"params": params}, h, method="logits"))
    chunked = jnp.concatenate(outs, axis=1)
    np.testing.assert_allclose(
        np.asarray(chunked), np.asarray(full), rtol=2e-4, atol=2e-4
    )


def test_greedy_matches_hf(pair):
    import torch

    hf, model, params = pair
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 128, (2, 7))

    with torch.no_grad():
        hf_out = hf.generate(
            torch.from_numpy(ids), max_new_tokens=8, do_sample=False,
            use_cache=True, pad_token_id=0,
        )[:, 7:].numpy()

    ours = np.asarray(greedy_generate(
        model, params, jnp.asarray(ids, jnp.int32), max_new_tokens=8
    ))
    np.testing.assert_array_equal(ours, hf_out)


def test_llava_greedy_generate():
    from clip_embeds.core.config import VisionConfig
    from clip_embeds.models.generate import llava_greedy_generate
    from clip_embeds.models.llava import Llava, LlavaConfig

    cfg = LlavaConfig(
        llama=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=64,
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg, attn_impl="reference")
    ids = jnp.asarray([[1, 5, -200, 7, 8]], jnp.int32)
    pixels = jnp.zeros((1, 32, 32, 3))
    params = model.init(jax.random.PRNGKey(0), ids, pixels)["params"]
    out = llava_greedy_generate(
        model, params, ids, pixels, max_new_tokens=6, eos_token_id=2
    )
    assert out.shape == (1, 6)
    assert np.asarray(out).min() >= 0

    # determinism and image dependence
    out2 = llava_greedy_generate(
        model, params, ids, pixels, max_new_tokens=6, eos_token_id=2
    )
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2))
    out3 = llava_greedy_generate(
        model, params, ids, pixels + 1.0, max_new_tokens=6, eos_token_id=2
    )
    assert not np.array_equal(np.asarray(out), np.asarray(out3))


# -- CoCa generation ---------------------------------------------------------


def test_coca_topk1_generation_matches_reference():
    """top_k=1 sampling is deterministic -> exact token parity vs a greedy
    decode over the reference torch CoCa forward (the reference's own
    CoCa.generate cannot run here: the installed transformers dropped
    BeamSearchScorer so its import guard trips — coca_model.py:308)."""
    import torch

    from tests.test_coca import ref_coca, _jax_model
    from clip_embeds.core.torch_convert import convert_coca_state_dict
    from clip_embeds.models.generate import coca_sample_generate

    ref = ref_coca.__wrapped__()
    model = _jax_model()
    params = convert_coca_state_dict(ref.state_dict())

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    seq_len = 12
    min_seq_len = 5
    with torch.no_grad():
        timg = torch.from_numpy(images.transpose(0, 3, 1, 2))
        out = torch.full((2, 1), 126, dtype=torch.long)
        done = torch.zeros(2, dtype=torch.bool)
        while out.shape[1] < seq_len:
            logits = ref(timg, out, output_labels=False)["logits"][:, -1]
            if out.shape[1] < min_seq_len:
                logits[:, 127] = -torch.inf
            nxt = logits.argmax(-1)
            if out.shape[1] == seq_len - 1:
                nxt = torch.full_like(nxt, 127)
            nxt = torch.where(done, torch.zeros_like(nxt), nxt)
            done = done | (nxt == 127)
            out = torch.cat([out, nxt[:, None]], dim=1)
        ref_out = out.numpy()

    got = np.asarray(coca_sample_generate(
        model, params, jnp.asarray(images), jax.random.PRNGKey(0),
        seq_len=seq_len, generation_type="top_k", top_k=1,
        sot_token_id=126, eos_token_id=127, pad_token_id=0, min_seq_len=5,
    ))
    np.testing.assert_array_equal(got, ref_out)


def test_coca_topp_generation_valid():
    """top_p sampling: valid tokens, sot prefix, eos termination, and
    determinism under a fixed key."""
    from tests.test_coca import ref_coca, _jax_model
    from clip_embeds.core.torch_convert import convert_coca_state_dict
    from clip_embeds.models.generate import coca_sample_generate

    ref = ref_coca.__wrapped__()
    model = _jax_model()
    params = convert_coca_state_dict(ref.state_dict())
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    out1 = np.asarray(coca_sample_generate(
        model, params, jnp.asarray(images), jax.random.PRNGKey(7),
        seq_len=10, generation_type="top_p", top_p=0.9,
        sot_token_id=126, eos_token_id=127, pad_token_id=0, min_seq_len=3,
    ))
    out2 = np.asarray(coca_sample_generate(
        model, params, jnp.asarray(images), jax.random.PRNGKey(7),
        seq_len=10, generation_type="top_p", top_p=0.9,
        sot_token_id=126, eos_token_id=127, pad_token_id=0, min_seq_len=3,
    ))
    np.testing.assert_array_equal(out1, out2)
    assert (out1[:, 0] == 126).all()
    assert out1.shape == (2, 10)
    assert ((out1 >= 0) & (out1 < 128)).all()
    # min length: no eos in the first min_seq_len generated positions
    assert not (out1[:, 1:3] == 127).any()


def test_coca_beam_generation():
    """Beam search: deterministic, well-formed, and the chosen beam's
    sequence log-prob is >= the greedy sequence's (beam must not lose to
    greedy under its own objective when both terminate identically)."""
    import torch

    from tests.test_coca import ref_coca, _jax_model
    from clip_embeds.core.torch_convert import convert_coca_state_dict
    from clip_embeds.models.generate import (
        coca_beam_generate,
        coca_sample_generate,
    )

    ref = ref_coca.__wrapped__()
    model = _jax_model()
    params = convert_coca_state_dict(ref.state_dict())
    rng = np.random.default_rng(2)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    seq_len = 10

    beam = np.asarray(coca_beam_generate(
        model, params, jnp.asarray(images), seq_len=seq_len, num_beams=4,
        sot_token_id=126, eos_token_id=127, pad_token_id=0, min_seq_len=3,
    ))
    beam2 = np.asarray(coca_beam_generate(
        model, params, jnp.asarray(images), seq_len=seq_len, num_beams=4,
        sot_token_id=126, eos_token_id=127, pad_token_id=0, min_seq_len=3,
    ))
    np.testing.assert_array_equal(beam, beam2)
    assert (beam[:, 0] == 126).all()

    greedy = np.asarray(coca_sample_generate(
        model, params, jnp.asarray(images), jax.random.PRNGKey(0),
        seq_len=seq_len, generation_type="top_k", top_k=1,
        sot_token_id=126, eos_token_id=127, pad_token_id=0, min_seq_len=3,
    ))

    def seq_logprob(tokens):
        logits = model.apply(
            {"params": params},
            *model.apply({"params": params}, jnp.asarray(images),
                         method="image_tokens")[1:],
            jnp.asarray(tokens), method="caption_logits",
        )
        logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))
        total = np.zeros(tokens.shape[0])
        for b in range(tokens.shape[0]):
            for t in range(1, tokens.shape[1]):
                tok = tokens[b, t]
                total[b] += logp[b, t - 1, tok]
                if tok == 127:
                    break
        return total

    assert (seq_logprob(beam) >= seq_logprob(greedy) - 1e-4).all()
