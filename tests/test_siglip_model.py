"""SigLIP model parity vs HF transformers (tiny config)."""

import numpy as np
import pytest

import jax.numpy as jnp

from clip_embeds.models.siglip import (
    Siglip,
    SiglipConfig,
    SiglipTextConfig,
    SiglipVisionConfig,
    convert_siglip_state_dict,
)

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


@pytest.fixture(scope="module")
def hf_model():
    torch = pytest.importorskip("torch")
    from transformers import SiglipConfig as HFConfig, SiglipModel

    cfg = HFConfig(
        vision_config=dict(hidden_size=64, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=128,
                           image_size=32, patch_size=16),
        text_config=dict(hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         vocab_size=200, max_position_embeddings=16),
    )
    torch.manual_seed(0)
    return SiglipModel(cfg).eval()


def tiny_cfg() -> SiglipConfig:
    return SiglipConfig(
        vision=SiglipVisionConfig(image_size=32, patch_size=16, width=64,
                                  layers=2, heads=4, intermediate_size=128),
        text=SiglipTextConfig(vocab_size=200, width=64, layers=2, heads=4,
                              intermediate_size=128,
                              max_position_embeddings=16),
    )


def test_siglip_parity(hf_model):
    import torch

    rng = np.random.default_rng(0)
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 200, (3, 16)).astype(np.int64)

    with torch.no_grad():
        # compare raw pooler outputs (the full model's .image_embeds is
        # L2-normalized in newer transformers)
        ref_img = hf_model.vision_model(
            torch.tensor(pixels).permute(0, 3, 1, 2)
        ).pooler_output.numpy()
        ref_txt = hf_model.text_model(torch.tensor(ids)).pooler_output.numpy()
        out = hf_model(
            input_ids=torch.tensor(ids[:2]),
            pixel_values=torch.tensor(pixels).permute(0, 3, 1, 2),
        )
    ref_logits = out.logits_per_text.numpy()

    model = Siglip(tiny_cfg(), attn_impl="reference")
    params = convert_siglip_state_dict(
        {k: v for k, v in hf_model.state_dict().items()}
    )
    got_img = np.asarray(model.apply(
        {"params": params}, jnp.asarray(pixels), False,
        method="encode_image",
    ))
    got_txt = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids.astype(np.int32)), False,
        method="encode_text",
    ))
    np.testing.assert_allclose(got_img, ref_img, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got_txt, ref_txt, rtol=3e-4, atol=3e-4)

    full = model.apply(
        {"params": params}, jnp.asarray(pixels),
        jnp.asarray(ids[:2].astype(np.int32)),
    )
    np.testing.assert_allclose(
        np.asarray(full["logits_per_text"]), ref_logits, rtol=3e-4, atol=3e-4
    )


def test_siglip_with_sigmoid_loss(hf_model):
    """The SigLIP model pairs with losses/siglip.py's sigmoid loss."""
    import jax

    from clip_embeds.losses.siglip import siglip_loss

    model = Siglip(tiny_cfg(), attn_impl="reference")
    params = convert_siglip_state_dict(
        {k: v for k, v in hf_model.state_dict().items()}
    )
    rng = np.random.default_rng(1)
    pixels = jnp.asarray(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    ids = jnp.asarray(rng.integers(1, 200, (2, 16)).astype(np.int32))
    out = model.apply({"params": params}, pixels, ids)
    loss = siglip_loss(
        out["image_features"], out["text_features"],
        jnp.log(out["logit_scale"]), out["logit_bias"],
    )
    assert np.isfinite(float(loss))


def test_siglip_scorer_protocols():
    """SiglipScorer: sigmoid pairing + driver softmax protocols on a tiny
    model with an injected stub tokenizer."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from clip_embeds.models.siglip import (
        Siglip,
        SiglipConfig,
        SiglipTextConfig,
        SiglipVisionConfig,
    )
    from clip_embeds.scores.scorers import SiglipScorer

    cfg = SiglipConfig(
        vision=SiglipVisionConfig(image_size=28, patch_size=14, width=32,
                                  layers=1, heads=2, intermediate_size=64),
        text=SiglipTextConfig(vocab_size=64, width=32, layers=1, heads=2,
                              intermediate_size=64,
                              max_position_embeddings=8),
    )
    model = Siglip(cfg)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)),
        jnp.zeros((1, 8), jnp.int32),
    )["params"]

    def tokenize(texts):
        out = np.ones((len(texts), 8), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:8]):
                out[i, j] = ord(ch) % 64
        return out

    scorer = SiglipScorer(model, params, tokenize, batch_size=2)
    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (30, 40, 3), dtype=np.uint8))
            for _ in range(3)]

    probs = scorer.sigmoid_scores(imgs, ["a cat", "a dog"])
    assert probs.shape == (3, 2) and ((probs > 0) & (probs < 1)).all()

    batch = scorer.score_batch([(imgs[0], ["a", "b"]), (imgs[1], ["c", "d"])])
    assert len(batch) == 2
    np.testing.assert_allclose(batch[0].sum(), 1.0, rtol=1e-5)

    pair = scorer.pair_score([imgs[0], imgs[1]], ["left", "right"])
    assert pair.shape == (2, 2)
    np.testing.assert_allclose(pair.sum(axis=1), 1.0, rtol=1e-5)


def test_siglip_e2e_with_native_tokenizer(tmp_path):
    """SigLIP dual encoder end to end through the pure-Python sentencepiece
    tokenizer (text/unigram.py) — no injected stub, no native dependency."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from PIL import Image

    from clip_embeds.models.siglip import (
        Siglip,
        SiglipConfig,
        SiglipTextConfig,
        SiglipVisionConfig,
    )
    from clip_embeds.scores.scorers import SiglipScorer
    from clip_embeds.text.tokenizer import SigLipTokenizer
    from clip_embeds.text.unigram import (
        CONTROL,
        NORMAL,
        UNKNOWN,
        write_model_proto,
    )

    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL),
              ("<unk>", 0.0, UNKNOWN)]
    for w in ["▁a", "▁photo", "▁of", "▁cat", "▁dog", "▁", "a", "o", "t"]:
        pieces.append((w, -3.0, NORMAL))
    path = tmp_path / "tiny.model"
    path.write_bytes(write_model_proto(pieces))
    tok = SigLipTokenizer(str(path), context_length=8)

    cfg = SiglipConfig(
        vision=SiglipVisionConfig(image_size=28, patch_size=14, width=32,
                                  layers=1, heads=2, intermediate_size=64),
        text=SiglipTextConfig(vocab_size=64, width=32, layers=1, heads=2,
                              intermediate_size=64,
                              max_position_embeddings=8),
    )
    model = Siglip(cfg)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)),
        jnp.zeros((1, 8), jnp.int32),
    )["params"]

    scorer = SiglipScorer(model, params, tok, batch_size=4)
    rng = np.random.default_rng(0)
    imgs = [Image.fromarray(rng.integers(0, 255, (30, 30, 3), np.uint8))
            for _ in range(2)]
    probs = scorer.sigmoid_scores(imgs, ["a photo of a cat",
                                         "a photo of a dog"])
    assert probs.shape == (2, 2)
    assert ((probs > 0) & (probs < 1)).all()
