"""Attention dispatch (ops/attention.py).

The cuDNN route runs only on a GPU. Its plumbing (the [B,H,N,D] <-> [B,N,H,D]
layout, causal masks with Nq != Nk, padding of odd lengths, boolean masks)
is shared with the ``impl="xla"`` form of ``jax.nn.dot_product_attention``,
which is checked here against ``reference_attention`` at the shapes the
models use, cut in batch. ``test_cudnn_route_matches_reference`` runs the
cuDNN route itself and needs the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clip_embeds.ops.attention import (
    attention_route,
    dot_product_attention,
    reference_attention,
)


def _suffix_mask(b, n_texts, ls, p):
    """Block-diagonal causal suffixes over a fully visible prefix
    (models/llama.py suffix_block)."""
    n = n_texts * ls
    i = np.arange(n)[:, None]
    j = np.arange(p + n)[None, :]
    js = j - p
    m = (j < p) | ((js <= i) & ((js // ls) == (i // ls)))
    return jnp.asarray(np.broadcast_to(m[None, None], (b, 1, n, p + n)))


def _key_padding(lengths, nk):
    return jnp.asarray(np.arange(nk)[None, :] < np.asarray(lengths)[:, None]
                       )[:, None, None, :]


# (batch, heads, q len, kv len, head dim, causal, mask function)
CASES = {
    # the four shapes of the models, cut in batch
    "vit_l14_336": (1, 16, 577, 577, 64, False, None),
    "clip_text": (2, 12, 77, 77, 64, True, None),
    "llava_prefill": (1, 32, 640, 640, 128, True, None),
    "llava_suffix": (1, 32, 128, 768, 128, False,
                     lambda: _suffix_mask(1, 4, 32, 640)),
    # masks and odd lengths
    "key_padding": (2, 4, 33, 33, 32, False, lambda: _key_padding([33, 20], 33)),
    "causal_key_padding": (2, 4, 33, 33, 32, True,
                           lambda: _key_padding([30, 9], 33)),
    "causal_suffix_odd": (2, 4, 5, 13, 16, True, None),
    "causal_suffix_even": (2, 4, 6, 14, 16, True, None),
    "boolean_mask_odd": (2, 3, 9, 11, 8, False, lambda: jnp.asarray(
        np.random.default_rng(0).random((2, 1, 9, 11)) < 0.7).at[..., 0].set(True)),
    "odd_kv_only": (2, 3, 8, 15, 8, False, None),
}


def _inputs(case, dtype=jnp.float32):
    b, h, nq, nk, d, _, _ = case
    ks = jax.random.split(jax.random.PRNGKey(nq * 7 + nk), 4)
    q = jax.random.normal(ks[0], (b, h, nq, d), dtype)
    k = jax.random.normal(ks[1], (b, h, nk, d), dtype)
    v = jax.random.normal(ks[2], (b, h, nk, d), dtype)
    g = jax.random.normal(ks[3], (b, h, nq, d), dtype)
    return q, k, v, g


@pytest.mark.parametrize("name", sorted(CASES))
def test_xla_route_forward_matches_reference(name):
    case = CASES[name]
    causal, mask = case[5], case[6]() if case[6] else None
    q, k, v, _ = _inputs(case)
    got = dot_product_attention(q, k, v, causal, mask, impl="xla")
    want = reference_attention(q, k, v, causal, mask)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_xla_route_gradient_matches_reference(name):
    case = CASES[name]
    causal, mask = case[5], case[6]() if case[6] else None
    q, k, v, g = _inputs(case)

    def loss(impl):
        return lambda q, k, v: jnp.sum(
            dot_product_attention(q, k, v, causal, mask, impl=impl) * g)

    got = jax.grad(loss("xla"), (0, 1, 2))(q, k, v)
    want = jax.grad(loss("reference"), (0, 1, 2))(q, k, v)
    for a, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w),
                                   atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("dtype,head_dim,platform,route", [
    (jnp.bfloat16, 64, "gpu", "cudnn"),
    (jnp.float16, 128, "gpu", "cudnn"),
    (jnp.bfloat16, 256, "gpu", "cudnn"),
    (jnp.float32, 64, "gpu", "reference"),   # cuDNN takes fp16/bf16 only
    (jnp.bfloat16, 72 + 4, "gpu", "reference"),  # not a multiple of 8
    (jnp.bfloat16, 320, "gpu", "reference"),  # above cuDNN's 256
    (jnp.bfloat16, 64, "cpu", "reference"),
])
def test_route_from_static_facts(dtype, head_dim, platform, route):
    assert attention_route(dtype, head_dim, platform) == route


def test_auto_on_cpu_is_the_reference():
    q, k, v, _ = _inputs(CASES["clip_text"])
    np.testing.assert_array_equal(
        np.asarray(dot_product_attention(q, k, v, True)),
        np.asarray(reference_attention(q, k, v, True)))


def test_unknown_impl_raises():
    q, k, v, _ = _inputs(CASES["odd_kv_only"])
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(q, k, v, impl="flash")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_cudnn_route_matches_reference(name, gpu):
    case = CASES[name]
    causal, mask = case[5], case[6]() if case[6] else None
    q, k, v, g = _inputs(case, jnp.bfloat16)

    def loss(impl, q, k, v):
        out = dot_product_attention(q, k, v, causal, mask, impl=impl)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))

    with jax.default_matmul_precision("highest"):
        args32 = [t.astype(jnp.float32) for t in (q, k, v)]
        want = reference_attention(*args32, causal, mask)
        want_g = jax.grad(lambda *a: loss("reference", *a), (0, 1, 2))(*args32)
    got = dot_product_attention(q, k, v, causal, mask, impl="cudnn")
    got_g = jax.grad(lambda *a: loss("cudnn", *a), (0, 1, 2))(q, k, v)
    # chip_smoke.ATTN_TOL: 2e-2 absolute plus two bf16 half-ulps relative
    for a, w in zip((got,) + tuple(got_g), (want,) + tuple(want_g)):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(w),
                                   atol=2e-2, rtol=2 ** -7)
