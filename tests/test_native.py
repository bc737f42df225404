"""Native C++ resize/normalize vs Pillow parity + threading."""

import time

import numpy as np
import pytest
from PIL import Image

from clip_embeds.image.preprocess import (
    native_resize_normalize,
    native_resize_normalize_batch,
    preprocess_pacl,
)
from clip_embeds.native.build import load_library


@pytest.fixture(scope="module")
def lib():
    lib = load_library()
    if lib is None:
        pytest.skip("native library unavailable (no g++?)")
    return lib


def test_bicubic_matches_pillow(lib):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (123, 200, 3), dtype=np.uint8)

    pil = Image.fromarray(img).resize((64, 64), Image.BICUBIC)
    pil_arr = np.asarray(pil).astype(np.float32) / 255.0

    mean = (0.0, 0.0, 0.0)
    std = (1.0, 1.0, 1.0)
    ours = native_resize_normalize(img, 64, mean, std, bicubic=True)
    # Pillow quantizes the intermediate to uint8; allow 1/255 + rounding slack
    assert np.abs(ours - pil_arr).max() < 2.5 / 255


def test_bilinear_matches_pacl_path(lib):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (97, 150, 3), dtype=np.uint8)
    ref = preprocess_pacl(img, 48)  # PIL BILINEAR + ImageNet stats
    ours = native_resize_normalize(
        img, 48, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225), bicubic=False
    )
    assert np.abs(ours - ref).max() < 0.03  # ~2.5/255 in normalized units


def test_batch_matches_single(lib):
    rng = np.random.default_rng(2)
    batch = rng.integers(0, 255, (6, 80, 60, 3), dtype=np.uint8)
    mean = (0.5, 0.5, 0.5)
    std = (0.3, 0.3, 0.3)
    whole = native_resize_normalize_batch(batch, 32, mean, std, num_threads=4)
    for i in range(6):
        one = native_resize_normalize(batch[i], 32, mean, std)
        np.testing.assert_allclose(whole[i], one, rtol=1e-5, atol=1e-6)


def test_upscale(lib):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
    pil = np.asarray(
        Image.fromarray(img).resize((48, 48), Image.BICUBIC)
    ).astype(np.float32) / 255.0
    ours = native_resize_normalize(img, 48, (0, 0, 0), (1, 1, 1))
    assert np.abs(ours - pil).max() < 2.5 / 255


def test_native_preprocess_clip_parity(lib):
    from clip_embeds.image.preprocess import (
        native_preprocess_clip,
        preprocess_clip,
    )

    rng = np.random.default_rng(5)
    for shape in [(123, 200, 3), (400, 250, 3), (112, 112, 3)]:
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        a = native_preprocess_clip(img, 112)
        b = preprocess_clip(img, 112)
        assert a.shape == b.shape == (112, 112, 3)
        # within one uint8 step in normalized units (Pillow fixed-point coeffs)
        assert np.abs(a - b).max() < 1.5 / 255 / 0.2686


# ---------------------------------------------------------------------------
# Native decode pipeline (decode.cpp): bytes -> normalized batch.
# Reference behavior: PIL decode + torchvision-geometry shortest-edge resize
# + center crop + normalize (open_clip transform.py image_transform eval
# path), reproduced bit-exactly by the C++ fast path for JPEG/PNG/WebP.
# ---------------------------------------------------------------------------

import io

from clip_embeds.core.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from clip_embeds.image.loader import (
    PrefetchLoader,
    decode_preprocess_batch,
    native_decode_preprocess,
)
from clip_embeds.image.preprocess import preprocess_clip


def _encode(arr: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt, **kw)
    return buf.getvalue()


def _pil_ref(blob: bytes, size: int = 96) -> np.ndarray:
    return preprocess_clip(Image.open(io.BytesIO(blob)).convert("RGB"), size)


def test_decode_batch_bit_exact_vs_pil(lib):
    rng = np.random.default_rng(3)
    shapes_fmts = [
        ((120, 200), "JPEG"), ((211, 97), "PNG"), ((96, 96), "WEBP"),
        ((97, 96), "PNG"), ((300, 110), "JPEG"), ((50, 400), "JPEG"),
    ]
    blobs = [
        _encode(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), fmt, quality=90)
        if fmt != "PNG" else
        _encode(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), fmt)
        for hw, fmt in shapes_fmts
    ]
    out, ok = decode_preprocess_batch(blobs, 96)
    assert ok.all()
    for i, blob in enumerate(blobs):
        # identical uint8 pixels -> identical float32 after the same normalize
        np.testing.assert_allclose(out[i], _pil_ref(blob), rtol=0, atol=1e-5)


def test_decode_native_claims_only_what_it_handles(lib):
    rng = np.random.default_rng(4)
    gray = Image.fromarray(
        rng.integers(0, 256, (80, 100), dtype=np.uint8), mode="L"
    )
    b_gray = io.BytesIO(); gray.save(b_gray, format="JPEG")
    rgba = Image.fromarray(
        rng.integers(0, 256, (60, 70, 4), dtype=np.uint8), mode="RGBA"
    )
    b_rgba = io.BytesIO(); rgba.save(b_rgba, format="PNG")
    blobs = [b_gray.getvalue(), b_rgba.getvalue()]

    res = native_decode_preprocess(blobs, 96)
    assert res is not None
    _, native_ok = res
    assert native_ok[0]          # grayscale JPEG: native handles (libjpeg RGB)
    assert not native_ok[1]      # alpha PNG: defers to PIL's convert("RGB")

    out, ok = decode_preprocess_batch(blobs, 96)  # fallback fills slot 1
    assert ok.all()
    for i, blob in enumerate(blobs):
        np.testing.assert_allclose(out[i], _pil_ref(blob), rtol=0, atol=1e-5)


def test_decode_corrupt_slot_is_flagged_and_zeroed(lib):
    rng = np.random.default_rng(5)
    good = _encode(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8), "PNG")
    out, ok = decode_preprocess_batch([b"not an image", good, b""], 96)
    assert list(ok) == [False, True, False]
    assert np.all(out[0] == 0.0) and np.all(out[2] == 0.0)


def test_decode_fast_jpeg_close_on_natural_images(lib):
    # DCT-domain downscaled decode deviates from the full decode but must
    # stay close on low-frequency (natural-image-like) content.
    rng = np.random.default_rng(6)
    y, x = np.mgrid[0:700, 0:900].astype(np.float32)
    img = np.stack(
        [128 + 80 * np.sin(x * 0.01 * (c + 1)) + 40 * np.cos(y * 0.008 * (c + 1))
         for c in range(3)], axis=-1)
    blob = _encode(np.clip(img, 0, 255).astype(np.uint8), "JPEG", quality=92)
    exact, _ = decode_preprocess_batch([blob], 96)
    fast, ok = decode_preprocess_batch([blob], 96, fast_jpeg=True)
    assert ok.all()
    a, b = exact.ravel(), fast.ravel()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.995


def test_prefetch_loader_matches_batch_call(lib, tmp_path):
    rng = np.random.default_rng(7)
    paths, blobs = [], []
    for i in range(5):
        blob = _encode(
            rng.integers(0, 256, (100 + 7 * i, 130, 3), dtype=np.uint8),
            "JPEG", quality=90)
        p = tmp_path / f"img{i}.jpg"
        p.write_bytes(blob)
        paths.append(str(p)); blobs.append(blob)
    ref, _ = decode_preprocess_batch(blobs, 64)

    got_paths, got = [], []
    for chunk, batch, ok in PrefetchLoader(paths, batch_size=2, image_size=64):
        assert ok.all()
        got_paths.extend(chunk); got.append(batch)
    assert got_paths == paths
    np.testing.assert_allclose(np.concatenate(got), ref, rtol=0, atol=0)


def test_probe_image_dimensions(lib):
    import ctypes

    rng = np.random.default_rng(8)
    for fmt in ("JPEG", "PNG", "WEBP"):
        blob = _encode(rng.integers(0, 256, (123, 77, 3), dtype=np.uint8), fmt)
        h = ctypes.c_int(); w = ctypes.c_int()
        assert lib.probe_image(
            ctypes.c_char_p(blob), len(blob),
            ctypes.byref(h), ctypes.byref(w)) == 1
        assert (h.value, w.value) == (123, 77)
    assert lib.probe_image(ctypes.c_char_p(b"junk"), 4,
                           ctypes.byref(h), ctypes.byref(w)) == 0


def test_decompression_bomb_defers_to_fallback(lib):
    # native path must refuse headers above PIL's MAX_IMAGE_PIXELS rather
    # than attempting the allocation (worker-thread bad_alloc would kill
    # the process)
    big = Image.new("RGB", (12000, 9000))  # 108 MP > 89.5 MP cap
    buf = io.BytesIO()
    big.save(buf, format="JPEG", quality=10)
    res = native_decode_preprocess([buf.getvalue()], 64)
    assert res is not None
    _, ok = res
    assert not ok[0]


def test_prefetch_loader_abandoned_iteration_terminates(lib, tmp_path):
    import threading
    import time as _time

    rng = np.random.default_rng(9)
    paths = []
    for i in range(12):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(
            rng.integers(0, 256, (60, 60, 3), dtype=np.uint8)
        ).save(p, format="JPEG")
        paths.append(str(p))

    before = threading.active_count()
    it = iter(PrefetchLoader(paths, batch_size=2, image_size=32, prefetch=1))
    next(it)
    it.close()  # abandon mid-iteration; producer must not deadlock
    deadline = _time.time() + 5.0
    while threading.active_count() > before and _time.time() < deadline:
        _time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_png_without_optional_codecs(mode, tmp_path, monkeypatch):
    """Built with zlib alone (a host without libjpeg/libwebp headers), the
    library decodes 8-bit RGB, gray and palette PNGs bit-exactly and hands
    JPEG to the PIL fallback."""
    import ctypes

    from clip_embeds.native import build

    lib_path = str(tmp_path / "libzlib_only.so")
    build._build(lib_path, optional_codecs=())
    monkeypatch.setattr(build, "_LIB", build._declare(ctypes.CDLL(lib_path)))
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:75, 0:120]
    arr = np.stack([(x * (c + 1) + y * (3 - c)) % 256 for c in range(3)],
                   axis=-1).astype(np.uint8)
    img = Image.fromarray(arr)
    if mode == "L":
        img = img.convert("L")
    elif mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE)
    png = io.BytesIO()
    img.save(png, format="PNG", optimize=True)  # adaptive row filters
    jpeg = _encode(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8), "JPEG")
    out, ok = native_decode_preprocess([png.getvalue(), jpeg], 64)
    assert list(ok) == [True, False]
    np.testing.assert_allclose(out[0], _pil_ref(png.getvalue(), 64),
                               rtol=0, atol=1e-5)
