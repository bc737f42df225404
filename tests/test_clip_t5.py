"""CLIP-T5 model + T5 VQAScore pipeline tests."""

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.clip_t5 import CLIPT5, CLIPT5Config
from clip_embeds.models.llava import IMAGE_TOKEN_INDEX
from clip_embeds.models.t5 import T5Config
from clip_embeds.scores.vqa_score import T5VQAScorer, t5_tokenizer_image_token

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def tiny():
    cfg = CLIPT5Config(
        t5=T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_heads=4),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = CLIPT5(cfg, attn_impl="reference")
    ids = jnp.asarray([[1, 2, IMAGE_TOKEN_INDEX, 3]], jnp.int32)
    pixels = jnp.zeros((1, 32, 32, 3))
    labels = jnp.asarray([[7, 8, 1]], jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids, pixels, labels)["params"]
    return model, params


def test_clip_t5_shapes():
    model, params = tiny()
    ids = jnp.asarray([[1, 2, IMAGE_TOKEN_INDEX, 3, 4]], jnp.int32)
    pixels = jnp.zeros((1, 32, 32, 3))
    labels = jnp.asarray([[7, 8, 1, -100]], jnp.int32)
    logits = model.apply({"params": params}, ids, pixels, labels)
    assert logits.shape == (1, 4, 256)


def test_t5_tokenizer_image_token():
    tok = lambda t: [5] * len(t.split())
    ids = t5_tokenizer_image_token("hello <image> world", tok)
    assert ids.count(IMAGE_TOKEN_INDEX) == 1


def test_t5_vqa_scorer():
    model, params = tiny()
    tok = lambda t: [2 + (sum(map(ord, w)) % 200) for w in t.split()] + [1]
    scorer = T5VQAScorer(model, params, tok, batch_size=2, pad_to_multiple=8)
    rng = np.random.default_rng(0)
    imgs = [
        Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8))
        for _ in range(3)
    ]
    scores = scorer.forward(imgs, ["a cat", "a dog", "a bird"])
    assert scores.shape == (3,)
    assert np.all(scores > 0) and np.all(scores <= 1)


def _toy_tok(t):
    return [2 + (sum(map(ord, w)) % 200) for w in t.split()] + [1]


def test_t5_vqa_feature_reuse_exactness():
    """forward_image_texts / forward_groups (vision encoded once, features
    spliced) must match the per-pair full forward — same math, different
    dispatch structure."""
    model, params = tiny()
    scorer = T5VQAScorer(model, params, _toy_tok, batch_size=3,
                         pad_to_multiple=8)
    rng = np.random.default_rng(1)
    imgs = [
        Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8))
        for _ in range(2)
    ]
    texts = ["a cat", "a very large spotted dog", "a bird"]

    # reference-shaped per-pair path
    ref = np.stack([
        scorer.forward([im] * len(texts), texts) for im in imgs
    ])
    one = scorer.forward_image_texts(imgs[0], texts)
    np.testing.assert_allclose(one, ref[0], rtol=2e-4, atol=2e-4)
    grp = scorer.forward_groups(imgs, [texts, texts])
    assert grp.shape == (2, 3)
    np.testing.assert_allclose(grp, ref, rtol=2e-4, atol=2e-4)


def test_t5_vqa_score_api_routes_groups():
    """Score(m x n) over the T5 factory goes through the grouped path and
    matches the per-pair result."""
    from clip_embeds.scores.score import T5VQAScore

    model, params = tiny()
    score = T5VQAScore(model, params, _toy_tok, group_size=2,
                       batch_size=4, pad_to_multiple=8)
    rng = np.random.default_rng(2)
    imgs = [
        Image.fromarray(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8))
        for _ in range(3)
    ]
    texts = ["one", "two words here"]
    got = score(imgs, texts)
    scorer = T5VQAScorer(model, params, _toy_tok, batch_size=4,
                         pad_to_multiple=8)
    ref = np.stack([scorer.forward([im] * 2, texts) for im in imgs])
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_clip_t5_int8_trunk():
    """W8A8 T5 trunk (quantize_clip_t5_trunk + quant_t5='dynamic'): runs,
    produces valid scores, and stays close to the fp path on a tiny model."""
    from clip_embeds.models.quant import quantize_clip_t5_trunk

    model, params = tiny()
    qparams = quantize_clip_t5_trunk(jax.device_get(params))
    # vision tower untouched; every targeted T5 projection replaced
    flat_q = jax.tree_util.tree_flatten_with_path(qparams)[0]
    q_names = {"/".join(str(getattr(p, "key", p)) for p in path)
               for path, _ in flat_q}
    assert any("kernel_q" in n and n.startswith("t5/") for n in q_names)
    assert not any("kernel_q" in n and n.startswith("vision_tower/")
                   for n in q_names)
    assert any(n.startswith("t5/lm_head/kernel") for n in q_names)  # fp head

    qmodel = CLIPT5(model.cfg, attn_impl="reference", quant_t5="dynamic")
    scorer = T5VQAScorer(model, params, _toy_tok, batch_size=2,
                         pad_to_multiple=8)
    qscorer = T5VQAScorer(qmodel, qparams, _toy_tok, batch_size=2,
                          pad_to_multiple=8)
    rng = np.random.default_rng(3)
    imgs = [
        Image.fromarray(rng.integers(0, 255, (28, 28, 3), dtype=np.uint8))
        for _ in range(2)
    ]
    texts = ["a cat", "a dog"]
    fp = scorer.forward(imgs, texts)
    q = qscorer.forward(imgs, texts)
    assert q.shape == fp.shape
    assert np.all(q > 0) and np.all(q <= 1)
    assert np.abs(q - fp).max() < 0.15  # tiny random model: loose gate
    # the feature-reuse path works under quant too
    q_grp = qscorer.forward_groups(imgs, [texts, texts])
    q_ref = np.stack([qscorer.forward([im] * 2, texts) for im in imgs])
    np.testing.assert_allclose(q_grp, q_ref, rtol=2e-3, atol=2e-3)


def test_clip_t5_checkpoint_conversion(tmp_path):
    """convert_clip_t5_state_dict on the reference CLIPT5 checkpoint layout
    (clip_t5.py:44-54: T5 keys + vision_tower.vision_tower.* +
    mm_projector.{0,2}); image-feature path checked against the torch side."""
    torch = pytest.importorskip("torch")
    from transformers import CLIPVisionConfig, CLIPVisionModel
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration as HFT5

    torch.manual_seed(0)
    vis = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2,
        num_attention_heads=2, image_size=32, patch_size=16,
        hidden_act="quick_gelu", attn_implementation="eager",
    )).eval()
    t5 = HFT5(HFT5Config(
        vocab_size=256, d_model=64, d_kv=16, d_ff=128, num_layers=2,
        num_heads=4, feed_forward_proj="gated-gelu",
        tie_word_embeddings=False,
    )).eval()
    projector = torch.nn.Sequential(
        torch.nn.Linear(64, 64), torch.nn.GELU(), torch.nn.Linear(64, 64)
    ).eval()

    sd = {}
    sd.update({f"vision_tower.vision_tower.{k}": v
               for k, v in vis.state_dict().items()})
    sd.update({f"mm_projector.{k}": v for k, v in projector.state_dict().items()})
    sd.update(t5.state_dict())
    # HF T5 state dicts omit shared for tied embeds sometimes; ensure present
    sd.setdefault("shared.weight", t5.shared.weight)

    from clip_embeds.core.torch_convert import convert_clip_t5_state_dict

    params = convert_clip_t5_state_dict(sd)
    assert set(params) == {"vision_tower", "multi_modal_projector", "t5"}

    cfg = CLIPT5Config(
        t5=T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_heads=4),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = CLIPT5(cfg, attn_impl="reference")

    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    got = model.apply({"params": params}, jnp.asarray(images),
                      method="encode_images")

    with torch.no_grad():
        hs = vis(torch.tensor(images).permute(0, 3, 1, 2),
                 output_hidden_states=True).hidden_states[-2]
        ref = projector(hs[:, 1:])  # feature_select 'patch'
    np.testing.assert_allclose(np.asarray(got), ref.numpy(),
                               rtol=3e-4, atol=3e-4)
