"""Serving driver (cli/embed.py): directory scan, corrupt-file skip,
tail-batch padding, bf16 + int8 paths."""

import json
import os

import numpy as np
from PIL import Image

from clip_embeds.cli.embed import list_images, main


def _mk_images(root, n=10):
    os.makedirs(root / "sub", exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(
            rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)
        ).save(root / "sub" / f"{i:02d}.jpg")
    (root / "sub" / "notes.txt").write_text("not an image")
    # corrupt jpg must be skipped, not crash
    (root / "sub" / "bad.jpg").write_bytes(b"\xff\xd8broken")


def test_list_images_and_manifest(tmp_path):
    _mk_images(tmp_path)
    paths = list_images(str(tmp_path))
    assert len(paths) == 11  # 10 good + bad.jpg (skipped later at decode)
    manifest = tmp_path / "list.txt"
    manifest.write_text("\n".join(paths[:3]))
    assert list_images(str(manifest)) == paths[:3]


def test_embed_cli_end_to_end(tmp_path):
    _mk_images(tmp_path)
    out = tmp_path / "emb.npy"
    rc = main([
        "--model", "test-tiny", "--input", str(tmp_path),
        "--output", str(out), "--batch-size", "4", "--fp32",
    ])
    assert rc == 0
    embs = np.load(out)
    assert embs.shape == (10, 64) and embs.dtype == np.float32
    # L2-normalized
    np.testing.assert_allclose(
        np.linalg.norm(embs, axis=-1), 1.0, rtol=1e-5
    )
    paths = json.load(open(str(out) + ".paths.json"))
    assert len(paths) == 10 and not any("bad.jpg" in p for p in paths)


def test_embed_cli_int8_close_to_fp(tmp_path):
    _mk_images(tmp_path, n=6)
    out_fp = tmp_path / "fp.npy"
    out_q = tmp_path / "q.npy"
    assert main([
        "--model", "test-tiny", "--input", str(tmp_path),
        "--output", str(out_fp), "--batch-size", "3", "--fp32",
    ]) == 0
    assert main([
        "--model", "test-tiny", "--input", str(tmp_path),
        "--output", str(out_q), "--batch-size", "3", "--fp32", "--int8",
    ]) == 0
    a, b = np.load(out_fp), np.load(out_q)
    cos = (a * b).sum(-1).mean()
    assert cos > 0.99, cos


def test_embed_cli_data_parallel_matches_single_device(tmp_path):
    """8-virtual-device sharded serving == single-device results."""
    import jax

    assert len(jax.devices()) == 8  # conftest virtual mesh
    _mk_images(tmp_path, n=9)
    out_dp = tmp_path / "dp.npy"
    out_sd = tmp_path / "sd.npy"
    assert main([
        "--model", "test-tiny", "--input", str(tmp_path),
        "--output", str(out_dp), "--batch-size", "8", "--fp32",
        "--data-parallel",
    ]) == 0
    assert main([
        "--model", "test-tiny", "--input", str(tmp_path),
        "--output", str(out_sd), "--batch-size", "8", "--fp32",
        "--no-data-parallel",
    ]) == 0
    np.testing.assert_allclose(
        np.load(out_dp), np.load(out_sd), rtol=1e-5, atol=1e-6
    )


def test_embed_cli_texts(tmp_path):
    """--input-texts route: captions -> normalized text embeddings."""
    from clip_embeds.cli.embed import main

    txt = tmp_path / "caps.txt"
    txt.write_text("a photo of a cat\na photo of a dog\nan aerial view\n")
    out = tmp_path / "temb.npy"
    rc = main([
        "--model", "test-tiny", "--input-texts", str(txt),
        "--output", str(out), "--batch-size", "2", "--fp32",
        "--no-data-parallel",
    ])
    assert rc == 0
    embs = np.load(out)
    assert embs.shape[0] == 3
    np.testing.assert_allclose(np.linalg.norm(embs, axis=1), 1.0, atol=1e-3)


def test_embed_cli_rejects_ambiguous_inputs(tmp_path):
    from clip_embeds.cli.embed import main

    assert main(["--model", "test-tiny",
                 "--output", str(tmp_path / "x.npy")]) == 1
