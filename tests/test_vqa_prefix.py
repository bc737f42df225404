"""VQAScore image-KV-prefix reuse: exactness vs the per-pair full forward.

The reference broadcasts m x n by re-running the full VLM forward per
(image, text) pair (t2v_metrics score.py:43-57, llava_model.py:289-370). The
redesign prefills the shared image+question prefix once per image
(models/llava.py Llava.prefill) and replays its KV across the n candidate
suffixes (Llava.suffix_logits). These tests pin the redesign to the pair
path bit-for-bit (same fp32 reference attention, same reductions) and cover
the int8 trunk route (models/quant.py quantize_llava_trunk).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.llava import (
    IMAGE_TOKEN_INDEX,
    Llava,
    LlavaConfig,
    extract_prefix_kv,
)


def tiny_cfg():
    return LlavaConfig(
        llama=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=256,
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )


def toy_tokenize(text):
    # deterministic word tokenizer with BOS=1 (stable across processes,
    # unlike hash())
    return [1] + [2 + (sum(map(ord, w)) % 200) for w in text.split()]


@pytest.fixture(scope="module")
def tiny_llava():
    cfg = tiny_cfg()
    model = Llava(cfg, attn_impl="reference")
    rng = np.random.default_rng(0)
    params = model.init(
        jax.random.PRNGKey(0),
        jnp.asarray([[1, IMAGE_TOKEN_INDEX, 5, 6]], jnp.int32),
        jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32),
    )["params"]
    return model, params


def _scorer(model, params, **kw):
    from clip_embeds.scores.vqa_score import VQAScorer

    kw.setdefault("batch_size", 2)
    kw.setdefault("pad_to_multiple", 8)
    kw.setdefault("suffix_pad_to_multiple", 4)
    return VQAScorer(model, params, toy_tokenize, bos_token_id=1,
                     pad_token_id=0, **kw)


def _image(seed=1):
    from PIL import Image

    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (40, 30, 3), dtype=np.uint8))


def test_prefix_reuse_matches_pair_path(tiny_llava):
    model, params = tiny_llava
    scorer = _scorer(model, params)
    img = _image()
    texts = ["a cat on a mat", "a dog", "three green apples on a table"]
    fast = scorer.forward_image_texts(img, texts)
    slow = scorer.forward([img] * len(texts), texts)
    assert fast.shape == (3,)
    np.testing.assert_allclose(fast, slow, rtol=2e-5, atol=2e-5)


def test_prefix_reuse_suffix_chunking(tiny_llava):
    """n > batch_size exercises the per-chunk suffix loop over one prefill."""
    model, params = tiny_llava
    scorer = _scorer(model, params, batch_size=2)
    img = _image(2)
    texts = [f"object number {i}" for i in range(5)]
    fast = scorer.forward_image_texts(img, texts)
    slow = scorer.forward([img] * len(texts), texts)
    np.testing.assert_allclose(fast, slow, rtol=2e-5, atol=2e-5)


def test_single_text_falls_back(tiny_llava):
    model, params = tiny_llava
    scorer = _scorer(model, params)
    img = _image(3)
    fast = scorer.forward_image_texts(img, ["a cat"])
    slow = scorer.forward([img], ["a cat"])
    np.testing.assert_allclose(fast, slow, rtol=1e-6)


def test_score_api_uses_grouped_path(tiny_llava):
    from clip_embeds.scores.score import VQAScore

    model, params = tiny_llava
    score = VQAScore(model, params, toy_tokenize, bos_token_id=1,
                     pad_token_id=0, batch_size=2, pad_to_multiple=8,
                     suffix_pad_to_multiple=4)
    assert score.image_texts_forward is not None
    imgs = [_image(4), _image(5)]
    texts = ["a cat", "a dog and a cat"]
    grouped = score(imgs, texts)
    pairwise = np.stack([
        score.pair_forward([im] * 2, texts) for im in imgs
    ])
    assert grouped.shape == (2, 2)
    np.testing.assert_allclose(grouped, pairwise, rtol=2e-5, atol=2e-5)


def test_grouped_path_chunks_at_group_size(tiny_llava):
    """m > group_size splits into full groups + a remainder group, and the
    chunked result equals the pair path (exercises the k-group boundary the
    defaults hide: group_size=8 caps the prefix-KV memory)."""
    from clip_embeds.scores.score import VQAScore

    model, params = tiny_llava
    score = VQAScore(model, params, toy_tokenize, bos_token_id=1,
                     pad_token_id=0, batch_size=2, pad_to_multiple=8,
                     suffix_pad_to_multiple=4, group_size=2)
    assert score.group_size == 2
    imgs = [_image(40), _image(41), _image(42)]  # 2-group + remainder of 1
    texts = ["a cat", "a dog and a cat"]
    grouped = score(imgs, texts)
    pairwise = np.stack([
        score.pair_forward([im] * 2, texts) for im in imgs
    ])
    assert grouped.shape == (3, 2)
    np.testing.assert_allclose(grouped, pairwise, rtol=2e-5, atol=2e-5)

    dataset = [
        {"images": [_image(50)], "texts": texts},
        {"images": [_image(51)], "texts": texts},
        {"images": [_image(52)], "texts": texts},
    ]
    out = score.batch_forward(dataset, batch_size=16)  # capped to group_size
    assert out.shape == (3, 1, 2)
    want = np.stack([
        score.pair_forward([s["images"][0]] * 2, texts) for s in dataset
    ])
    np.testing.assert_allclose(out[:, 0], want, rtol=2e-5, atol=2e-5)


def test_batch_forward_uses_grouped_path(tiny_llava):
    from clip_embeds.scores.score import VQAScore

    model, params = tiny_llava
    score = VQAScore(model, params, toy_tokenize, bos_token_id=1,
                     pad_token_id=0, batch_size=2, pad_to_multiple=8,
                     suffix_pad_to_multiple=4)
    dataset = [
        {"images": [_image(10), _image(11)], "texts": ["a cat", "a dog"]},
        {"images": [_image(12), _image(13)], "texts": ["one", "two fish"]},
    ]
    grouped = score.batch_forward(dataset)
    assert grouped.shape == (2, 2, 2)
    # pin against the pair path element-wise
    for si, s in enumerate(dataset):
        for ii in range(2):
            want = score.pair_forward([s["images"][ii]] * 2, s["texts"])
            np.testing.assert_allclose(grouped[si, ii], want, rtol=2e-5,
                                       atol=2e-5)


def test_prefill_suffix_logits_match_full_forward(tiny_llava):
    """Plumbing-level exactness incl. padded prefix slots: full-forward
    logits at the suffix positions == suffix_logits over the cached KV."""
    model, params = tiny_llava
    cfg = model.cfg
    rng = np.random.default_rng(7)
    pixels = jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32)

    prefix_tokens = [1, 9, IMAGE_TOKEN_INDEX, 17, 23]       # real prefix
    suffixes = [[40, 41, 42], [50, 51, 0]]                   # row 1 padded
    suffix_mask = np.asarray([[1, 1, 1], [1, 1, 0]], bool)

    # full forward per row
    n_image = cfg.n_image_tokens
    full_rows = []
    for sfx, m in zip(suffixes, suffix_mask):
        ids = jnp.asarray([prefix_tokens + list(sfx)], jnp.int32)
        am = jnp.asarray(
            [[True] * len(prefix_tokens) + list(m)], bool)
        logits = model.apply({"params": params}, ids, pixels, am)
        full_rows.append(np.asarray(
            logits[0, len(prefix_tokens) - 1 + n_image:]))
    expected = np.stack(full_rows)

    # prefill (with right padding) + suffix
    lp_pad = 8
    prefix_ids = np.zeros((1, lp_pad), np.int32)
    prefix_ids[0, : len(prefix_tokens)] = prefix_tokens
    prefix_valid = np.zeros((1, lp_pad), bool)
    prefix_valid[0, : len(prefix_tokens)] = True
    pmask, mut = model.apply(
        {"params": params}, jnp.asarray(prefix_ids), pixels,
        jnp.asarray(prefix_valid), method="prefill", mutable=["kv"],
    )
    kv = extract_prefix_kv(mut["kv"], cfg.llama.num_layers)
    real_f = len(prefix_tokens) - 1 + n_image
    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(suffixes, jnp.int32), kv,
        pmask, jnp.asarray(suffix_mask),
        jnp.asarray(real_f, jnp.int32), method="suffix_logits",
    ))
    # padded row tail is masked garbage — compare valid positions only
    np.testing.assert_allclose(got[0], expected[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1, :2], expected[1, :2], rtol=2e-5,
                               atol=2e-5)


def test_int8_trunk_scores_close(tiny_llava):
    from clip_embeds.models.quant import quantize_llava_trunk

    model, params = tiny_llava
    qmodel = Llava(tiny_cfg(), attn_impl="reference", quant_llm="dynamic")
    qparams = quantize_llava_trunk(jax.device_get(params))
    img = _image(6)
    texts = ["a cat on a mat", "a dog"]
    fp = _scorer(model, params).forward_image_texts(img, texts)
    q = _scorer(qmodel, qparams).forward_image_texts(img, texts)
    assert q.shape == fp.shape
    assert np.all(np.abs(q - fp) < 0.15), (q, fp)
    # int8 params really are int8
    leaf = qparams["language_model"]["model"]["layers_0"]["self_attn"][
        "q_proj"]["kernel_q"]
    assert leaf.dtype == np.int8


def test_int8_trunk_embed_last_token(tiny_llava):
    """VLM2Vec embedding mode over the W8A8 trunk (the MMEB eval served
    with a quantized 7B)."""
    from clip_embeds.models.quant import quantize_llava_trunk

    model, params = tiny_llava
    qmodel = Llava(tiny_cfg(), attn_impl="reference", quant_llm="dynamic")
    qparams = quantize_llava_trunk(jax.device_get(params))
    ids = np.full((2, 8), 7, np.int32)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    pixels = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, 32, 32, 3)),
        jnp.float32)
    mask = np.ones((2, 8), bool)
    fp = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids), pixels, jnp.asarray(mask),
        method="embed_last_token"), np.float32)
    q = np.asarray(qmodel.apply(
        {"params": qparams}, jnp.asarray(ids), pixels, jnp.asarray(mask),
        method="embed_last_token"), np.float32)
    assert q.shape == fp.shape
    cos = (q * fp).sum(-1)  # both L2-normalized
    assert np.all(cos > 0.98), cos


def test_prefix_kv_gqa_exactness():
    """Prefix-KV replay under grouped-query attention (kv_heads < heads):
    the prefix KV is cached PRE-GQA-repeat and repeated after concat —
    suffix logits must equal the full causal forward (llava-llama-3 /
    Qwen2-family trunks are GQA)."""
    from clip_embeds.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_layers=2, num_heads=8, num_kv_heads=2,
        max_position_embeddings=64,
    )
    model = LlamaForCausalLM(cfg, attn_impl="reference")
    rng = np.random.default_rng(0)
    full_ids = jnp.asarray(rng.integers(1, 120, (2, 12)), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), full_ids)["params"]
    want = np.asarray(model.apply({"params": params}, full_ids), np.float32)

    p_len = 7

    def trunk(ids, **kw):
        return model.apply({"params": params},
                           model.apply({"params": params}, ids,
                                       method="embed"),
                           **kw)

    # prefill the first p_len tokens, sowing KV
    _, mut = model.apply(
        {"params": params},
        model.apply({"params": params}, full_ids[:, :p_len], method="embed"),
        None, None, False, None, True,
        method="trunk", mutable=["kv"],
    )
    tree = mut["kv"]["model"]
    kv = tuple(
        (tree[f"layers_{i}"]["self_attn"]["k"][0],
         tree[f"layers_{i}"]["self_attn"]["v"][0])
        for i in range(cfg.num_layers)
    )
    assert kv[0][0].shape[1] == 2  # cached at kv_heads, pre-repeat

    suffix = full_ids[:, p_len:]
    n_sfx = suffix.shape[1]
    positions = p_len + jnp.broadcast_to(jnp.arange(n_sfx)[None], (2, n_sfx))
    hidden = model.apply(
        {"params": params},
        model.apply({"params": params}, suffix, method="embed"),
        None, positions, False, kv, False,
        method="trunk",
    )
    got = np.asarray(model.apply({"params": params}, hidden,
                                 method="logits"), np.float32)
    np.testing.assert_allclose(got, want[:, p_len:], rtol=2e-5, atol=2e-5)


def test_scan_llm_matches_unrolled(tiny_llava):
    """scan_llm=True (lax.scan trunk, stacked params): logits and the full
    KV-reuse scorer path match the unrolled trunk. The scan layout exists
    for compile time — one layer body instead of a 32x-unrolled HLO at 7B."""
    from clip_embeds.models.llava import stack_llava_params

    model, params = tiny_llava
    smodel = Llava(tiny_cfg(), attn_impl="reference", scan_llm=True)
    sparams = stack_llava_params(jax.device_get(params))

    rng = np.random.default_rng(4)
    ids = jnp.asarray([[1, 9, IMAGE_TOKEN_INDEX, 17, 23, 40]], jnp.int32)
    pixels = jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32)
    want = np.asarray(model.apply({"params": params}, ids, pixels),
                      np.float32)
    got = np.asarray(smodel.apply({"params": sparams}, ids, pixels),
                     np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    img = _image(9)
    texts = ["a cat on a mat", "a dog", "many small boxes"]
    fast_scan = _scorer(smodel, sparams).forward_image_texts(img, texts)
    fast = _scorer(model, params).forward_image_texts(img, texts)
    np.testing.assert_allclose(fast_scan, fast, rtol=2e-5, atol=2e-5)


def test_scan_llm_int8_trunk(tiny_llava):
    """scan + W8A8 trunk compose (stacked QuantDense params)."""
    from clip_embeds.models.llava import stack_llava_params
    from clip_embeds.models.quant import quantize_llava_trunk

    model, params = tiny_llava
    qs_params = stack_llava_params(
        quantize_llava_trunk(jax.device_get(params)))
    qsmodel = Llava(tiny_cfg(), attn_impl="reference", scan_llm=True,
                    quant_llm="dynamic")
    img = _image(10)
    texts = ["a cat", "a dog"]
    q = _scorer(qsmodel, qs_params).forward_image_texts(img, texts)
    fp = _scorer(model, params).forward_image_texts(img, texts)
    assert np.all(np.abs(q - fp) < 0.15), (q, fp)


def test_batched_prefill_per_row_prefix_len(tiny_llava):
    """BATCHED prefill of two DIFFERENT images with different real prefix
    lengths, scored in one suffix batch with per-row prefix_len (the
    suffix positions/masks/KV are all per-row) — must equal the per-row
    full forwards. This is the building block for amortizing the prefill
    dispatch across a dataset's images."""
    model, params = tiny_llava
    cfg = model.cfg
    n_image = cfg.n_image_tokens
    rng = np.random.default_rng(11)
    pixels = jnp.asarray(rng.standard_normal((2, 32, 32, 3)), jnp.float32)

    rows = [[1, 9, IMAGE_TOKEN_INDEX, 17, 23],          # real len 5
            [1, IMAGE_TOKEN_INDEX, 31, 37, 41, 43]]     # real len 6
    suffixes = np.asarray([[40, 41, 42], [50, 51, 52]], np.int32)
    suffix_mask = np.ones((2, 3), bool)

    # per-row full forwards (each with its own image)
    expected = []
    for i, r in enumerate(rows):
        ids = jnp.asarray([r + list(suffixes[i])], jnp.int32)
        logits = model.apply({"params": params}, ids, pixels[i : i + 1])
        expected.append(np.asarray(logits[0, len(r) - 1 + n_image:]))

    # one batched prefill (right-padded to a common width)
    lp = 8
    prefix_ids = np.zeros((2, lp), np.int32)
    prefix_valid = np.zeros((2, lp), bool)
    for i, r in enumerate(rows):
        prefix_ids[i, : len(r)] = r
        prefix_valid[i, : len(r)] = True
    pmask, mut = model.apply(
        {"params": params}, jnp.asarray(prefix_ids), pixels,
        jnp.asarray(prefix_valid), method="prefill", mutable=["kv"],
    )
    kv = extract_prefix_kv(mut["kv"], cfg.llama.num_layers)
    real_f = jnp.asarray(
        [len(r) - 1 + n_image for r in rows], jnp.int32)
    got = np.asarray(model.apply(
        {"params": params}, jnp.asarray(suffixes), kv, pmask,
        jnp.asarray(suffix_mask), real_f, method="suffix_logits",
    ))
    np.testing.assert_allclose(got[0], expected[0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[1], expected[1], rtol=2e-5, atol=2e-5)


def test_concatenated_suffix_block_mode(tiny_llava):
    """suffix_block: n candidate suffixes CONCATENATED in one row attend
    block-diagonally over one shared prefix KV — logits per block equal the
    separate-rows layout (the KV-replication-free batched m x n form)."""
    model, params = tiny_llava
    cfg = model.cfg
    rng = np.random.default_rng(13)
    pixels = jnp.asarray(rng.standard_normal((1, 32, 32, 3)), jnp.float32)

    prefix_tokens = [1, 9, IMAGE_TOKEN_INDEX, 17, 23]
    lp = 8
    prefix_ids = np.zeros((1, lp), np.int32)
    prefix_ids[0, : len(prefix_tokens)] = prefix_tokens
    prefix_valid = np.zeros((1, lp), bool)
    prefix_valid[0, : len(prefix_tokens)] = True
    pmask, mut = model.apply(
        {"params": params}, jnp.asarray(prefix_ids), pixels,
        jnp.asarray(prefix_valid), method="prefill", mutable=["kv"],
    )
    kv = extract_prefix_kv(mut["kv"], cfg.llama.num_layers)
    real_f = jnp.asarray(
        len(prefix_tokens) - 1 + cfg.n_image_tokens, jnp.int32)

    texts = np.asarray([[40, 41, 42, 43], [50, 51, 52, 53]], np.int32)
    # (a) separate rows
    sep = np.asarray(model.apply(
        {"params": params}, jnp.asarray(texts), kv, pmask,
        jnp.ones((2, 4), bool), real_f, method="suffix_logits",
    ))
    # (b) one concatenated row, block width 4
    cat = np.asarray(model.apply(
        {"params": params}, jnp.asarray(texts.reshape(1, 8)), kv, pmask,
        jnp.ones((1, 8), bool), real_f, method="suffix_logits",
        suffix_block=4,
    ))
    np.testing.assert_allclose(cat.reshape(2, 4, -1), sep, rtol=2e-5,
                               atol=2e-5)


def test_forward_groups_matches_per_image(tiny_llava):
    """forward_groups (ONE batched prefill + ONE concatenated-suffix pass
    for k images x n texts) == the per-image KV path == the pair path."""
    model, params = tiny_llava
    scorer = _scorer(model, params)
    images = [_image(20), _image(21), _image(22)]
    texts = [["a cat", "a dog on a mat"],
             ["one small fish", "two"],
             ["red box", "blue round ball here"]]
    grouped = scorer.forward_groups(images, texts)
    assert grouped.shape == (3, 2)
    for i in range(3):
        per_image = scorer.forward_image_texts(images[i], texts[i])
        np.testing.assert_allclose(grouped[i], per_image, rtol=2e-5,
                                   atol=2e-5)


def test_forward_groups_fallback_single_text(tiny_llava):
    model, params = tiny_llava
    scorer = _scorer(model, params)
    grouped = scorer.forward_groups([_image(23)], [["a cat"]])
    slow = scorer.forward([_image(23)], ["a cat"])
    np.testing.assert_allclose(grouped[0], slow, rtol=1e-6)


def test_batch_forward_uses_groups_path(tiny_llava):
    from clip_embeds.scores.score import VQAScore

    model, params = tiny_llava
    score = VQAScore(model, params, toy_tokenize, bos_token_id=1,
                     pad_token_id=0, batch_size=2, pad_to_multiple=8,
                     suffix_pad_to_multiple=4)
    assert score.groups_forward is not None
    dataset = [
        {"images": [_image(30), _image(31)], "texts": ["a cat", "a dog"]},
        {"images": [_image(32), _image(33)], "texts": ["one", "two fish"]},
        {"images": [_image(34), _image(35)], "texts": ["x y", "z w v"]},
    ]
    grouped = score.batch_forward(dataset, batch_size=2)
    assert grouped.shape == (3, 2, 2)
    for si, s in enumerate(dataset):
        for ii in range(2):
            want = score.pair_forward([s["images"][ii]] * 2, s["texts"])
            np.testing.assert_allclose(grouped[si, ii], want, rtol=2e-5,
                                       atol=2e-5)


def test_call_m_by_n_uses_groups_path(tiny_llava):
    """Score(images[m], texts[n]) routes the m x n broadcast through
    forward_groups (every image scores the same n texts = one k-group) and
    matches the reference-shaped pair loop."""
    from clip_embeds.scores.score import VQAScore

    model, params = tiny_llava
    score = VQAScore(model, params, toy_tokenize, bos_token_id=1,
                     pad_token_id=0, batch_size=2, pad_to_multiple=8,
                     suffix_pad_to_multiple=4)
    images = [_image(40), _image(41), _image(42)]
    texts = ["a cat", "two small fish", "red box"]
    got = score(images, texts)
    assert got.shape == (3, 3)
    for i, img in enumerate(images):
        want = score.pair_forward([img] * 3, texts)
        np.testing.assert_allclose(got[i], want, rtol=2e-5, atol=2e-5)
