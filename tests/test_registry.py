"""Registry parity: 126 model configs + ~180 pretrained entries resolve."""

import pytest

from clip_embeds.core.config import get_model_config
from clip_embeds.core.openclip_registry import (
    classify_model,
    get_pretrained_cfg,
    is_pretrained_cfg,
    list_openclip_models,
    list_pretrained,
    list_pretrained_models_by_tag,
    list_pretrained_tags_by_model,
    resolve_clip_config,
    resolve_siglip_config,
)


def test_registry_counts():
    models = list_openclip_models()
    assert len(models) == 126  # reference model_configs/*.json count
    pairs = list_pretrained()
    assert len(pairs) >= 158  # reference pretrained.py table (+quickgelu)
    assert ("ViT-L-14-336", "openai") in pairs
    assert "ViT-B-32:laion2b_s34b_b79k" in list_pretrained(as_str=True)


def test_every_model_classifies():
    backends = {}
    for name in list_openclip_models():
        backend, detail = classify_model(name)
        assert backend in {"clip", "siglip", "coca", "hf-text", "unsupported"}, name
        backends.setdefault(backend, []).append(name)
    # every native-vit/rn config must actually resolve to a CLIPConfig
    for name in backends["clip"]:
        cfg = resolve_clip_config(name)
        assert cfg.embed_dim > 0 and cfg.vision.width > 0
    assert len(backends["clip"]) >= 80
    assert len(backends["siglip"]) >= 26  # nllb hybrids route to hf-text now
    assert len(backends["hf-text"]) >= 9
    assert len(backends.get("unsupported", [])) <= 4
    assert "coca_ViT-B-32" in backends["coca"]


def test_clip_config_mapping_details():
    cfg = get_model_config("ViT-B-16-plus-240")
    assert cfg.vision.image_size == 240
    assert cfg.vision.width == 896
    assert cfg.embed_dim == 640

    cfg = get_model_config("ViT-S-32")
    assert cfg.vision.width == 384 and cfg.text.width == 384

    rn = get_model_config("RN50x16")
    assert rn.vision.tower == "resnet"
    assert rn.vision.resnet_layers == (6, 8, 18, 8)
    assert rn.vision.image_size == 384

    # CLIPA: no ln_pre, avg pool, last-token text pooling
    clipa = get_model_config("ViT-L-14-CLIPA")
    assert clipa.vision.no_ln_pre and clipa.vision.pool_type == "avg"
    assert clipa.text.pool_type == "last"

    # quickgelu alias arch
    qg = get_model_config("ViT-B-32-quickgelu")
    assert qg.quick_gelu


def test_siglip_config_mapping():
    cfg = resolve_siglip_config("ViT-SO400M-14-SigLIP-384")
    assert cfg.vision.width == 1152
    assert cfg.vision.layers == 27
    assert cfg.vision.image_size == 384
    assert cfg.vision.patch_size == 14
    assert cfg.text.max_position_embeddings == 64

    cfg = resolve_siglip_config("ViT-B-16-SigLIP-512")
    assert cfg.vision.width == 768 and cfg.vision.image_size == 512

    with pytest.raises(NotImplementedError):
        resolve_siglip_config("convnext_base_w")


def test_pretrained_cfg_api():
    cfg = get_pretrained_cfg("ViT-L-14-336", "openai")
    assert cfg["quick_gelu"] is True
    assert cfg["url"].endswith("ViT-L-14-336px.pt")
    assert cfg["mean"] == [0.48145466, 0.4578275, 0.40821073]

    # siglip entries carry inception stats + squash resize
    sl = get_pretrained_cfg("ViT-SO400M-14-SigLIP-384", "webli")
    assert sl["mean"] == [0.5, 0.5, 0.5] and sl["resize_mode"] == "squash"

    assert is_pretrained_cfg("RN50", "yfcc15m")
    assert "openai" in list_pretrained_tags_by_model("ViT-B-16")
    assert "ViT-B-32" in list_pretrained_models_by_tag("laion2b_e16")
    # derived quickgelu aliases exist as their own archs
    assert is_pretrained_cfg("ViT-B-32-quickgelu", "openai")


def test_every_registry_arch_is_native():
    """Since the fastvit towers landed, all 126 reference model configs
    classify to a native backend — nothing is 'unsupported' anymore."""
    from clip_embeds.core.openclip_registry import (
        _registry,
        classify_model,
    )

    backends = {n: classify_model(n)[0]
                for n in _registry()["model_configs"]}
    unsupported = {n: b for n, b in backends.items()
                   if b in ("unsupported", "unknown")}
    assert not unsupported, unsupported
    with pytest.raises(KeyError):
        get_model_config("not-a-model")


def test_download_pretrained_mocked(tmp_path, monkeypatch):
    """Mocked download path (reference tests/test_download_pretrained.py):
    URL resolution, cache writes, and cache short-circuiting — no network."""
    import urllib.request

    from clip_embeds.core.openclip_registry import (
        download_pretrained,
        get_pretrained_cfg,
    )

    calls = []

    def fake_urlretrieve(url, target):
        calls.append(url)
        with open(target, "wb") as f:
            f.write(b"ckpt")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)

    cfg = get_pretrained_cfg("RN50", "openai")
    assert cfg.get("url") or cfg.get("hf_hub")
    if not cfg.get("url"):
        pytest.skip("RN50/openai entry resolves via hf_hub only")
    path = download_pretrained(cfg, cache_dir=str(tmp_path))
    assert path.startswith(str(tmp_path))
    assert open(path, "rb").read() == b"ckpt"
    assert len(calls) == 1 and calls[0] == cfg["url"]

    # second call hits the cache, no new download
    assert download_pretrained(cfg, cache_dir=str(tmp_path)) == path
    assert len(calls) == 1


def test_download_pretrained_hf_hub_only_raises(tmp_path):
    from clip_embeds.core.openclip_registry import download_pretrained

    with pytest.raises(FileNotFoundError, match="hf_hub"):
        download_pretrained({"hf_hub": "org/repo/"}, cache_dir=str(tmp_path))


def test_pretrained_table_entries_resolvable():
    """Every pretrained entry carries a weight source (url or hf_hub) —
    the table integrity the reference's mocked download tests rely on."""
    from clip_embeds.core.openclip_registry import (
        get_pretrained_cfg,
        list_pretrained,
    )

    missing = []
    for arch, tag in list_pretrained():
        cfg = get_pretrained_cfg(arch, tag)
        if not (cfg.get("url") or cfg.get("hf_hub")):
            missing.append((arch, tag))
    assert not missing, missing[:10]
