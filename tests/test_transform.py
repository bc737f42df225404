"""image.transform: train augmentation + eval resize modes.

Covers the reference transform.py surface (open_clip/src/open_clip/
transform.py): RandomResizedCrop get_params semantics (:276-345 train branch,
torchvision geometry), ColorJitter/Grayscale simclr augmentations, the
'longest'/'squash'/'shortest' eval resize modes with ResizeKeepRatio (:88) and
CenterCropOrPad (:207), per-pretrained-entry preprocess cfgs, and the train
data-route wiring (datamix/csv/wds + --aug-cfg CLI parsing).
"""

import numpy as np
import pytest
from PIL import Image

from clip_embeds.image.transform import (
    AugmentationCfg,
    PreprocessCfg,
    center_crop_or_pad,
    color_jitter_image,
    grayscale3,
    image_transform,
    image_transform_v2,
    pretrained_preprocess_cfg,
    random_resized_crop_params,
    resize_keep_ratio,
    sample_rng,
)


def _img(h=96, w=128, seed=0):
    arr = np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)
    return Image.fromarray(arr)


# -- RandomResizedCrop geometry ------------------------------------------------


def test_rrc_params_within_bounds_and_scale():
    rng = np.random.default_rng(0)
    h_img, w_img = 100, 160
    scale, ratio = (0.9, 1.0), (3 / 4, 4 / 3)
    for _ in range(200):
        top, left, h, w = random_resized_crop_params(rng, h_img, w_img,
                                                     scale, ratio)
        assert 0 <= top <= h_img - h and 0 <= left <= w_img - w
        area_frac = (h * w) / (h_img * w_img)
        # a sampled crop sits in the scale range (rounding slack); the
        # 10-try fallback is a ratio-clamped max crop touching an edge
        in_range = scale[0] - 0.03 <= area_frac <= scale[1] + 0.03
        is_fallback = h == h_img or w == w_img
        assert in_range or is_fallback
        assert ratio[0] * 0.95 <= w / h <= ratio[1] * 1.05


def test_rrc_fallback_center_crop_for_extreme_aspect():
    # a 10x1000 strip cannot host a 3/4..4/3 crop at 90% area -> torchvision
    # falls back to a ratio-clamped centered crop
    rng = np.random.default_rng(0)
    top, left, h, w = random_resized_crop_params(
        rng, 10, 1000, (0.9, 1.0), (3 / 4, 4 / 3))
    assert h == 10 and w == round(10 * 4 / 3)
    assert top == 0 and left == (1000 - w) // 2


def test_rrc_deterministic_under_seed():
    a = random_resized_crop_params(np.random.default_rng(7), 100, 100,
                                   (0.5, 1.0), (3 / 4, 4 / 3))
    b = random_resized_crop_params(np.random.default_rng(7), 100, 100,
                                   (0.5, 1.0), (3 / 4, 4 / 3))
    assert a == b


def test_rrc_area_distribution_uniform():
    """target_area ~ U(scale): with ratio pinned to 1 nothing is rejected,
    so mean(area frac) ~= mid-scale (torchvision get_params sampling)."""
    rng = np.random.default_rng(1)
    fracs = []
    for _ in range(500):
        _, _, h, w = random_resized_crop_params(rng, 200, 200, (0.5, 1.0),
                                                (1.0, 1.0))
        fracs.append(h * w / 200 / 200)
    assert abs(np.mean(fracs) - 0.75) < 0.03


# -- color jitter / grayscale --------------------------------------------------


def test_color_jitter_zero_cfg_is_identity():
    img = _img()
    out = color_jitter_image(img, np.random.default_rng(0))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(img))


def test_color_jitter_brightness_matches_imageenhance():
    from PIL import ImageEnhance

    img = _img()
    rng = np.random.default_rng(3)
    out = color_jitter_image(img, rng, brightness=0.4)
    # replay the factor draw: first uniform from the same stream
    f = np.random.default_rng(3).uniform(0.6, 1.4)
    ref = ImageEnhance.Brightness(img).enhance(f)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_color_jitter_changes_image_and_is_seeded():
    img = _img()
    a = color_jitter_image(img, np.random.default_rng(5), 0.4, 0.4, 0.4, 0.1)
    b = color_jitter_image(img, np.random.default_rng(5), 0.4, 0.4, 0.4, 0.1)
    c = color_jitter_image(img, np.random.default_rng(6), 0.4, 0.4, 0.4, 0.1)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(img))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_grayscale3_replicates_luma():
    out = np.asarray(grayscale3(_img()))
    np.testing.assert_array_equal(out[..., 0], out[..., 1])
    np.testing.assert_array_equal(out[..., 0], out[..., 2])
    # ITU-R 601-2 luma (PIL convert('L'))
    ref = np.asarray(_img().convert("L"))
    np.testing.assert_array_equal(out[..., 0], ref)


# -- eval resize modes ---------------------------------------------------------


def test_resize_keep_ratio_longest_fits_inside():
    img = _img(100, 50)
    out = resize_keep_ratio(img, 64, longest=1.0)
    assert max(out.size) == 64 and out.size == (32, 64)  # (w, h)


def test_center_crop_or_pad_pads_then_crops():
    arr = np.ones((64, 32, 3), np.uint8) * 7
    out = center_crop_or_pad(arr, 64, fill=0)
    assert out.shape == (64, 64, 3)
    # padded columns left 16 / right 16 (ltrb split: (32)//2, (33)//2)
    assert (out[:, :16] == 0).all() and (out[:, 48:] == 0).all()
    assert (out[:, 16:48] == 7).all()


def test_center_crop_or_pad_crops_large():
    arr = np.arange(10 * 8 * 3, dtype=np.uint8).reshape(10, 8, 3)
    out = center_crop_or_pad(arr, 4)
    np.testing.assert_array_equal(out, arr[3:7, 2:6])


def test_eval_longest_mode_shape_and_fill():
    fn = image_transform(64, is_train=False, resize_mode="longest",
                         mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                         fill_color=0)
    out = fn(_img(100, 50))
    assert out.shape == (64, 64, 3)
    # the 100x50 image scales to 64x32; the pad band must be exactly 0
    assert (out[:, :16] == 0).all() and (out[:, 48:] == 0).all()
    assert np.abs(out[:, 16:48]).mean() > 0.1


def test_eval_shortest_matches_preprocess_clip():
    from clip_embeds.image.preprocess import preprocess_clip

    img = _img(120, 90)
    fn = image_transform(64, is_train=False, resize_mode="shortest")
    np.testing.assert_allclose(fn(img), preprocess_clip(img, 64), atol=1e-6)


def test_eval_squash_matches_preprocess_siglip():
    from clip_embeds.image.preprocess import preprocess_siglip

    img = _img(120, 90)
    fn = image_transform(64, is_train=False, resize_mode="squash",
                         mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
    np.testing.assert_allclose(fn(img), preprocess_siglip(img, 64), atol=1e-6)


def test_pretrained_preprocess_cfg_siglip_entry():
    cfg = pretrained_preprocess_cfg("ViT-B-16-SigLIP", "webli", 224)
    assert cfg.resize_mode == "squash"
    assert cfg.mean == (0.5, 0.5, 0.5) and cfg.std == (0.5, 0.5, 0.5)
    fn = image_transform_v2(cfg, is_train=False)
    assert fn(_img()).shape == (224, 224, 3)


def test_pretrained_preprocess_cfg_default_is_clip():
    cfg = pretrained_preprocess_cfg("ViT-B-32", "", 224)
    assert cfg.resize_mode == "shortest"
    assert cfg == PreprocessCfg(size=224)


# -- train transform -----------------------------------------------------------


def test_train_transform_shapes_and_determinism():
    fn = image_transform(64, is_train=True)
    img = _img(100, 140)
    a = fn(img, sample_rng(0, 0, 5))
    b = fn(img, sample_rng(0, 0, 5))
    c = fn(img, sample_rng(0, 0, 6))
    assert a.shape == (64, 64, 3) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_train_transform_differs_from_eval():
    img = _img(100, 140)
    train = image_transform(64, is_train=True)(img, sample_rng(1, 0, 0))
    ev = image_transform(64, is_train=False)(img)
    assert not np.allclose(train, ev)


def test_train_transform_aug_cfg_dict_and_gray():
    fn = image_transform(
        48, is_train=True,
        aug_cfg={"scale": [0.8, 1.0],
                 "color_jitter": (0.4, 0.4, 0.4, 0.1),
                 "color_jitter_prob": 1.0, "gray_scale_prob": 1.0},
    )
    out = fn(_img(), sample_rng(0, 0, 0))
    assert out.shape == (48, 48, 3)
    # gray_scale_prob=1 -> unnormalized channels equal; verify via de-normalize
    from clip_embeds.core.constants import (
        OPENAI_DATASET_MEAN,
        OPENAI_DATASET_STD,
    )

    u8 = out * np.asarray(OPENAI_DATASET_STD) + np.asarray(OPENAI_DATASET_MEAN)
    np.testing.assert_allclose(u8[..., 0], u8[..., 1], atol=1e-6)


def test_train_transform_use_timm_subset():
    """use_timm branch (reachable subset: RRC + always-on ColorJitter +
    RandomErasing — AugmentationCfg has no auto_augment field, so this IS
    the full reachable timm config surface, transform.py:305-323)."""
    fn = image_transform(
        48, is_train=True,
        aug_cfg={"use_timm": True, "scale": (0.8, 1.0),
                 "color_jitter": 0.4, "re_prob": 1.0, "re_count": 2},
    )
    a = fn(_img(), sample_rng(0, 0, 1))
    b = fn(_img(), sample_rng(0, 0, 1))
    assert a.shape == (48, 48, 3)
    np.testing.assert_array_equal(a, b)
    # re_prob=1: at least one erased rectangle of N(0,1) noise exists ->
    # some pixels sit far outside the normalized-image value range
    plain = image_transform(
        48, is_train=True,
        aug_cfg={"use_timm": True, "scale": (0.8, 1.0),
                 "color_jitter": 0.4},
    )(_img(), sample_rng(0, 0, 1))
    assert not np.array_equal(a, plain)


def test_train_transform_timm_random_interpolation():
    """interpolation='random' in the timm branch picks bilinear/bicubic PER
    IMAGE (timm RandomResizedCropAndInterpolation); outside the timm train
    branch it degrades to bicubic like the reference (transform.py:295)."""
    kw = dict(is_train=True,
              aug_cfg={"use_timm": True, "scale": (0.99, 1.0)})
    rnd = image_transform(48, interpolation="random", **kw)
    bic = image_transform(48, interpolation="bicubic", **kw)
    bil = image_transform(48, interpolation="bilinear", **kw)
    # same rng stream -> same crop; the interp coin decides which pinned
    # output each sample matches, and across seeds BOTH must occur
    matches = set()
    for seed in range(12):
        r = rnd(_img(), sample_rng(0, 0, seed))
        if np.array_equal(r, bic(_img(), sample_rng(0, 0, seed))):
            matches.add("bicubic")
        elif np.array_equal(r, bil(_img(), sample_rng(0, 0, seed))):
            matches.add("bilinear")
    assert matches == {"bicubic", "bilinear"}, matches
    # eval path: 'random' pins to bicubic
    ev_r = image_transform(48, is_train=False, interpolation="random")
    ev_b = image_transform(48, is_train=False, interpolation="bicubic")
    np.testing.assert_array_equal(ev_r(_img()), ev_b(_img()))


def test_random_erasing_geometry():
    from clip_embeds.image.transform import random_erasing

    arr = np.zeros((64, 64, 3), np.float32)
    out = random_erasing(arr, np.random.default_rng(0), probability=1.0)
    changed = np.abs(out).sum(-1) > 0
    assert changed.any()
    frac = changed.mean()
    assert 0.01 < frac < 0.4  # area in [0.02, 1/3] up to rounding
    assert (arr == 0).all()   # input untouched (copy-on-write)
    out2 = random_erasing(arr, np.random.default_rng(1), probability=0.0)
    assert out2 is arr


def test_aug_cfg_color_jitter_prob_requires_4tuple():
    with pytest.raises(AssertionError):
        image_transform(64, is_train=True,
                        aug_cfg={"color_jitter": 0.4,
                                 "color_jitter_prob": 0.8})


# -- data-route wiring ---------------------------------------------------------


def _write_images(tmp_path, n=4, size=(80, 100)):
    paths = []
    for i in range(n):
        arr = np.random.default_rng(i).integers(0, 255, (*size, 3), np.uint8)
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    return paths


def test_csv_batches_train_transform(tmp_path):
    from clip_embeds.data.csv_dataset import CsvPairDataset, csv_batches
    from clip_embeds.text.tokenizer import get_tokenizer

    paths = _write_images(tmp_path)
    csv_file = tmp_path / "data.tsv"
    csv_file.write_text(
        "filepath\ttitle\n"
        + "".join(f"{p}\ta photo {i}\n" for i, p in enumerate(paths))
    )
    ds = CsvPairDataset(str(csv_file))
    tok = get_tokenizer()
    tf = image_transform(32, is_train=True)

    def batches(epoch):
        return list(csv_batches(ds, 2, 32, tok, epoch=epoch, seed=3,
                                train_transform=tf))

    a, b = batches(0), batches(0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["images"], y["images"])
    assert a[0]["images"].shape == (2, 32, 32, 3)
    # a different epoch reshuffles AND redraws crops
    c = batches(1)
    assert not all(
        np.array_equal(x["images"], y["images"]) for x, y in zip(a, c)
    )


def test_datamix_train_transform(tmp_path):
    import json

    from clip_embeds.data.datamix import DataMixDataset, datamix_batches

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    _write_images(img_dir, n=4)
    ann = [
        {"image": f"img_{i}.png",
         "conversations": [{"value": "q"}, {"value": f"caption {i}"}]}
        for i in range(4)
    ]
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(ann))
    # all sample paths start with 'i' (not '0') -> datamix665k root
    tf = image_transform(32, is_train=True)
    ds = DataMixDataset([str(ann_file)],
                        {"lcs558k": str(img_dir),
                         "datamix665k": str(img_dir)},
                        image_size=32, train_transform=tf)
    a = list(datamix_batches(ds, 2, shuffle=False, seed=0, num_workers=2))
    b = list(datamix_batches(ds, 2, shuffle=False, seed=0, num_workers=2))
    assert a[0]["images"].shape == (2, 32, 32, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["images"], y["images"])
    # augmented != the deterministic eval transform
    from clip_embeds.image.preprocess import preprocess_clip

    ev = preprocess_clip(str(img_dir / "img_0.png"), 32)
    assert not np.allclose(a[0]["images"][0], ev)


def test_wds_batches_train_transform(tmp_path):
    import io
    import tarfile

    from clip_embeds.data.wds import (
        ShardedTarDataset,
        decode_raw_image_text,
        wds_batches,
    )
    from clip_embeds.text.tokenizer import get_tokenizer

    tar_path = tmp_path / "shard-000000.tar"
    with tarfile.open(tar_path, "w") as tar:
        for i in range(4):
            arr = np.random.default_rng(i).integers(0, 255, (60, 80, 3),
                                                    np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            data = buf.getvalue()
            info = tarfile.TarInfo(f"{i:06d}.png")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
            txt = f"caption {i}".encode()
            info = tarfile.TarInfo(f"{i:06d}.txt")
            info.size = len(txt)
            tar.addfile(info, io.BytesIO(txt))

    ds = ShardedTarDataset(str(tar_path), decode=decode_raw_image_text,
                           sample_shuffle_size=0)
    tf = image_transform(32, is_train=True)
    a = list(wds_batches(ds, 2, image_size=32, tokenizer=get_tokenizer(),
                         train_transform=tf, seed=1))
    b = list(wds_batches(ds, 2, image_size=32, tokenizer=get_tokenizer(),
                         train_transform=tf, seed=1))
    assert len(a) == 2 and a[0]["images"].shape == (2, 32, 32, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["images"], y["images"])


def test_train_cli_aug_cfg_parsing():
    from clip_embeds.cli.train import build_train_transform, parse_args

    args = parse_args([
        "--aug-cfg", "scale=(0.8, 1.0)", "color_jitter=(0.4,0.4,0.4,0.1)",
        "color_jitter_prob=0.8", "gray_scale_prob=0.2",
    ])
    assert args.aug_cfg == {
        "scale": (0.8, 1.0), "color_jitter": (0.4, 0.4, 0.4, 0.1),
        "color_jitter_prob": 0.8, "gray_scale_prob": 0.2,
    }

    class _V:
        image_size = 48

    class _Cfg:
        vision = _V()

    fn = build_train_transform(args, _Cfg())
    out = fn(_img(), sample_rng(0, 0, 0))
    assert out.shape == (48, 48, 3)
    args_off = parse_args(["--no-train-aug"])
    assert build_train_transform(args_off, _Cfg()) is None


def test_create_model_and_transforms_entry_preprocess():
    from clip_embeds.core.factory import create_model_and_transforms
    from clip_embeds.image.preprocess import preprocess_clip

    model, params, preprocess, tok, preprocess_train = (
        create_model_and_transforms("test-tiny", aug_cfg={})
    )
    img = _img(60, 80)
    size = model.cfg.vision.image_size
    np.testing.assert_allclose(preprocess(img), preprocess_clip(img, size),
                               atol=1e-6)
    out = preprocess_train(img, sample_rng(0, 0, 0))
    assert out.shape == (size, size, 3)


def test_get_score_model_hpsv2_pickscore(monkeypatch):
    """hpsv2 / pickscore-v1 resolve to live CLIPScore scorers
    (reference clipscore_models/{hpsv2,pickscore}_model.py). The real arch is
    ViT-H-14 (~1B params); the alias table is patched to the tiny test arch
    so the full construction + m x n scoring path runs in-test."""
    from clip_embeds.scores import registry

    monkeypatch.setitem(registry.CLIPSCORE_ALIASES, "hpsv2",
                        ("test-tiny", "clip"))
    monkeypatch.setitem(registry.CLIPSCORE_ALIASES, "pickscore-v1",
                        ("test-tiny", "clip"))
    for name in ("hpsv2", "pickscore-v1"):
        score = registry.get_score_model(name)
        out = score([_img()], ["a cat", "a dog"])
        assert out.shape == (1, 2)
        assert np.isfinite(out).all()
    assert registry.CLIPSCORE_ALIASES["hpsv2"][0] == "test-tiny"


def test_profile_trace_capture(tmp_path):
    from clip_embeds.cli.profile import capture_trace

    out = capture_trace("test-tiny", str(tmp_path / "trace"), batch_size=2,
                        steps=1)
    import os

    found = [f for _, _, fs in os.walk(out) for f in fs]
    assert any(f.endswith(".xplane.pb") or "trace" in f for f in found), found
