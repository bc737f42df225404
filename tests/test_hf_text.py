"""Encoder-LM text towers (HFTextEncoder role) tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.models.hf_text import (
    BertTextConfig,
    BertTextTower,
    T5TextTower,
    mean_pool,
)
from clip_embeds.models.t5 import T5Config

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def test_mean_pool_masked():
    hidden = jnp.asarray([[[1.0, 1.0], [3.0, 3.0], [100.0, 100.0]]])
    mask = jnp.asarray([[1, 1, 0]])
    out = mean_pool(hidden, mask)
    np.testing.assert_allclose(np.asarray(out), [[2.0, 2.0]])


def test_t5_text_tower():
    cfg = T5Config(vocab_size=128, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4)
    tower = T5TextTower(cfg, embed_dim=16)
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 128, (3, 9)))
    mask = jnp.ones((3, 9), bool)
    params = tower.init(jax.random.PRNGKey(0), ids, mask)["params"]
    out = tower.apply({"params": params}, ids, mask)
    assert out.shape == (3, 16)
    # masked positions must not affect the embedding
    ids2 = ids.at[:, 7:].set(99)
    mask2 = mask.at[:, 7:].set(False)
    a = tower.apply({"params": params}, ids, mask2)
    b = tower.apply({"params": params}, ids2, mask2)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-5)


def test_bert_text_tower():
    cfg = BertTextConfig(vocab_size=128, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64)
    tower = BertTextTower(cfg, embed_dim=16, pooler="first")
    ids = jnp.asarray(np.random.default_rng(1).integers(0, 128, (2, 7)))
    params = tower.init(jax.random.PRNGKey(0), ids)["params"]
    out = tower.apply({"params": params}, ids)
    assert out.shape == (2, 16)


def test_build_custom_text_clip_registry_archs():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from clip_embeds.models.custom_text_clip import (
        HF_TEXT_SHAPES,
        build_custom_text_clip,
    )
    from clip_embeds.core.openclip_registry import (
        classify_model,
        list_openclip_models,
    )

    # every hf-text arch in the registry must resolve to a buildable module
    archs = [n for n in list_openclip_models()
             if classify_model(n)[0] == "hf-text"]
    # roberta x3, mt5 x2, nllb x2 plain-ViT + nllb-siglip hybrids x2
    assert len(archs) == 9
    for n in archs:
        m = build_custom_text_clip(n)
        assert m.cfg.hf_model_name in HF_TEXT_SHAPES

    # tiny end-to-end forward on a shrunken roberta config
    m = build_custom_text_clip("roberta-ViT-B-32")
    import dataclasses as dc

    from clip_embeds.core.config import VisionConfig

    tiny = dc.replace(
        m.cfg,
        vision=VisionConfig(image_size=32, patch_size=16, width=32, layers=1,
                            head_width=16),
    )
    from clip_embeds.models.custom_text_clip import CustomTextCLIP

    m = CustomTextCLIP(tiny)
    # tiny vision tower + the real roberta-base text shapes on a 4-token batch
    imgs = jnp.zeros((1, 32, 32, 3))
    ids = jnp.zeros((1, 4), jnp.int32)
    params = m.init(jax.random.PRNGKey(0), imgs, ids)["params"]
    out = m.apply({"params": params}, imgs, ids)
    assert out["image_features"].shape == (1, 512)
    assert out["text_features"].shape == (1, 512)
    assert np.isfinite(np.asarray(out["text_features"])).all()


def test_m2m100_nllb_encoder_parity():
    """M2M100TextTower == HF M2M100 encoder (tiny config), incl. padded
    rows and the cls pooler."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import pytest as _pytest

    torch = _pytest.importorskip("torch")
    from transformers import M2M100Config as HFConfig
    from transformers.models.m2m_100.modeling_m2m_100 import M2M100Encoder

    from clip_embeds.models.hf_text import (
        M2M100Config,
        M2M100TextTower,
        convert_m2m100_encoder_state_dict,
    )

    hf_cfg = HFConfig(
        vocab_size=128, d_model=32, encoder_layers=2,
        encoder_attention_heads=4, encoder_ffn_dim=64,
        max_position_embeddings=64, pad_token_id=1,
        scale_embedding=True, dropout=0.0, attention_dropout=0.0,
    )
    torch.manual_seed(0)
    ref = M2M100Encoder(hf_cfg).eval()

    cfg = M2M100Config(
        vocab_size=128, d_model=32, num_layers=2, num_heads=4, ffn_dim=64,
        max_position_embeddings=64, pad_token_id=1,
    )
    params = convert_m2m100_encoder_state_dict(
        {"encoder." + k: v for k, v in ref.state_dict().items()}, cfg
    )
    # random projection on top (not in the HF encoder)
    tower = M2M100TextTower(cfg, embed_dim=16)
    ids = np.asarray([[5, 9, 22, 71, 2, 1, 1, 1],
                      [6, 30, 2, 1, 1, 1, 1, 1]], np.int32)
    mask = (ids != 1).astype(np.int32)
    full = tower.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    full.update(params)

    with torch.no_grad():
        want = ref(
            input_ids=torch.tensor(ids.astype(np.int64)),
            attention_mask=torch.tensor(mask.astype(np.int64)),
        ).last_hidden_state.numpy()

    # compare the pooled (first-token) path through our proj
    got = tower.apply(
        {"params": full}, jnp.asarray(ids), jnp.asarray(mask)
    )
    want_pooled = want[:, 0] @ np.asarray(full["proj"]["kernel"])
    np.testing.assert_allclose(np.asarray(got), want_pooled,
                               rtol=2e-4, atol=2e-4)


def test_nllb_siglip_hybrid_assembly():
    """nllb-clip-*-siglip: SigLIP MAP-pooled vision + NLLB text encoder
    through CustomTextCLIP (registry hybrid routing + tiny e2e forward)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from clip_embeds.core.openclip_registry import classify_model
    from clip_embeds.models.custom_text_clip import (
        CustomTextCLIP,
        CustomTextCLIPConfig,
    )
    from clip_embeds.core.config import VisionConfig
    from clip_embeds.models.siglip import SiglipVisionConfig

    backend, detail = classify_model("nllb-clip-base-siglip")
    assert backend == "hf-text" and "siglip" in detail
    backend, _ = classify_model("nllb-clip-large-siglip")
    assert backend == "hf-text"

    # tiny hybrid: same wiring, scaled-down shapes
    from clip_embeds.models.custom_text_clip import HF_TEXT_SHAPES

    HF_TEXT_SHAPES["tiny/nllb"] = dict(
        kind="m2m100", vocab_size=128, d_model=32, num_layers=2,
        num_heads=2, ffn_dim=64,
    )
    try:
        cfg = CustomTextCLIPConfig(
            embed_dim=48, vision=VisionConfig(),
            hf_model_name="tiny/nllb", pooler="first",
            init_logit_bias=-10.0,
            siglip_vision=SiglipVisionConfig(
                image_size=32, patch_size=16, width=48, layers=2, heads=2,
                intermediate_size=96,
            ),
        )
        model = CustomTextCLIP(cfg, attn_impl="reference")
        params = model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            jnp.zeros((1, 8), jnp.int32),
        )["params"]
        out = model.apply(
            {"params": params}, jnp.zeros((1, 32, 32, 3)),
            jnp.asarray([[3, 5, 7, 2, 0, 0, 0, 0]], jnp.int32),
            jnp.asarray([[1, 1, 1, 1, 0, 0, 0, 0]], bool),
        )
        assert out["image_features"].shape == (1, 48)
        assert out["text_features"].shape == (1, 48)
        assert float(out["logit_bias"]) == -10.0
        assert np.isfinite(np.asarray(out["image_features"])).all()
    finally:
        HF_TEXT_SHAPES.pop("tiny/nllb")
