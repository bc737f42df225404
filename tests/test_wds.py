"""Sharded tar pipeline tests — on-the-fly shard fixtures like the reference
tests/test_wds.py (builds tars with PNG/txt pairs, asserts counts/epochs)."""

import io
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from clip_embeds.data.wds import (
    ShardedTarDataset,
    decode_image_text,
    decode_raw_image_text,
    expand_urls,
    iter_tar_samples,
    wds_batches,
)


def _build_shards(tmp_path, counts=(10, 5)):
    """Write tar shards with img+txt pairs (reference test_wds.py:19-52)."""
    paths = []
    rng = np.random.default_rng(0)
    idx = 0
    for si, n in enumerate(counts):
        path = tmp_path / f"shard-{si:03d}.tar"
        with tarfile.open(path, "w") as tf:
            for _ in range(n):
                img = Image.fromarray(
                    rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)
                )
                buf = io.BytesIO()
                img.save(buf, format="PNG")
                data = buf.getvalue()
                info = tarfile.TarInfo(f"{idx:06d}.png")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                txt = f"caption {idx}".encode()
                info = tarfile.TarInfo(f"{idx:06d}.txt")
                info.size = len(txt)
                tf.addfile(info, io.BytesIO(txt))
                idx += 1
        paths.append(str(path))
    return paths


def test_expand_urls():
    assert expand_urls("s-{000..002}.tar") == [
        "s-000.tar", "s-001.tar", "s-002.tar"
    ]
    assert expand_urls("plain.tar") == ["plain.tar"]


def test_iter_tar_samples(tmp_path):
    paths = _build_shards(tmp_path, (4,))
    samples = list(iter_tar_samples(paths[0]))
    assert len(samples) == 4
    assert set(samples[0]) == {"png", "txt", "__key__"}


def test_sample_counts_and_decode(tmp_path):
    _build_shards(tmp_path, (10, 5))
    ds = ShardedTarDataset(
        str(tmp_path / "shard-{000..001}.tar"),
        decode=decode_image_text,
        sample_shuffle_size=8,
    )
    samples = list(ds(epoch=0))
    assert len(samples) == 15
    assert all("image" in s and "text" in s for s in samples)


def test_deterministic_epoch_shuffle(tmp_path):
    _build_shards(tmp_path, (10, 5))
    ds = ShardedTarDataset(
        str(tmp_path / "shard-{000..001}.tar"), decode=decode_image_text,
        sample_shuffle_size=16,
    )
    a1 = [s["text"] for s in ds(epoch=0)]
    a2 = [s["text"] for s in ds(epoch=0)]
    b = [s["text"] for s in ds(epoch=1)]
    assert a1 == a2               # same epoch -> identical order
    assert sorted(a1) == sorted(b)
    assert a1 != b                # different epoch -> reshuffled


def test_resampled_with_weights(tmp_path):
    _build_shards(tmp_path, (10, 5))
    ds = ShardedTarDataset(
        str(tmp_path / "shard-{000..001}.tar"), decode=decode_image_text,
        resampled=True, weights=[1.0, 0.0], seed=3,
    )
    texts = [s["text"] for s in ds(epoch=0)]
    # only shard 0 samples can appear (captions 0..9)
    assert all(int(t.split()[-1]) < 10 for t in texts)


def test_corrupt_shard_tolerated(tmp_path):
    paths = _build_shards(tmp_path, (6,))
    bad = tmp_path / "shard-001.tar"
    bad.write_bytes(b"this is not a tar file")
    ds = ShardedTarDataset(
        [paths[0], str(bad)], decode=decode_image_text, shuffle_shards=False
    )
    samples = list(ds(epoch=0, num_workers=1))
    assert len(samples) == 6  # corrupt shard skipped, good one intact


def test_wds_batches(tmp_path):
    _build_shards(tmp_path, (10, 5))
    ds = ShardedTarDataset(
        str(tmp_path / "shard-{000..001}.tar"), decode=decode_image_text
    )
    batches = list(wds_batches(ds, batch_size=4, image_size=16))
    assert len(batches) == 3  # drop_last
    assert batches[0]["images"].shape == (4, 16, 16, 3)
    assert batches[0]["texts"].shape == (4, 77)


def test_wds_batches_native_decode_matches_pil(tmp_path):
    """decode_raw_image_text + native batch decode == decode_image_text path
    (the C++ resample is bit-exact vs PIL), incl. a corrupt member dropping
    with refill."""
    _build_shards(tmp_path, (10,))
    url = str(tmp_path / "shard-000.tar")
    ds_pil = ShardedTarDataset(
        url, decode=decode_image_text, shuffle_shards=False,
        sample_shuffle_size=0,
    )
    ds_raw = ShardedTarDataset(
        url, decode=decode_raw_image_text, shuffle_shards=False,
        sample_shuffle_size=0,
    )
    ref = list(wds_batches(ds_pil, batch_size=4, image_size=16))
    got = list(wds_batches(ds_raw, batch_size=4, image_size=16))
    assert len(ref) == len(got) == 2
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g["images"], r["images"], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(g["texts"], r["texts"])


def test_wds_batches_native_drops_corrupt_and_refills(tmp_path):
    import io as _io
    import tarfile

    from PIL import Image as _Image

    tar_path = tmp_path / "mix.tar"
    rng = np.random.default_rng(0)
    with tarfile.open(tar_path, "w") as tf:
        for i in range(9):
            if i == 2:
                img_bytes = b"corrupt image bytes"
            else:
                buf = _io.BytesIO()
                _Image.fromarray(
                    rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
                ).save(buf, format="PNG")
                img_bytes = buf.getvalue()
            for ext, data in (("png", img_bytes),
                              (("txt"), f"caption {i}".encode())):
                info = tarfile.TarInfo(f"{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, _io.BytesIO(data))

    ds = ShardedTarDataset(
        str(tar_path), decode=decode_raw_image_text, shuffle_shards=False,
        sample_shuffle_size=0,
    )
    batches = list(wds_batches(ds, batch_size=4, image_size=16))
    # 8 valid of 9 -> two full batches, corrupt sample refilled from later
    assert len(batches) == 2
    assert batches[0]["images"].shape == (4, 16, 16, 3)
