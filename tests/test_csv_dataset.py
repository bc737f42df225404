"""CSV/TSV dataset (reference open_clip_train/data.py:136-155 CsvDataset):
column contract, per-epoch determinism, native batch decode parity, and
--dataset-type csv / webdataset / auto train CLI wiring."""

import io
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from clip_embeds.data.csv_dataset import CsvPairDataset, csv_batches
from clip_embeds.image.preprocess import preprocess_clip
from clip_embeds.text.tokenizer import get_tokenizer


def _write_corpus(tmp_path, n=10, sep="\t", img_key="filepath",
                  caption_key="title"):
    rng = np.random.default_rng(0)
    rows = [sep.join([img_key, caption_key])]
    for i in range(n):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(
            rng.integers(0, 256, (40 + i, 60, 3), dtype=np.uint8)
        ).save(p, format="JPEG", quality=90)
        rows.append(sep.join([str(p), f"caption number {i}"]))
    csv_path = tmp_path / ("data.tsv" if sep == "\t" else "data.csv")
    csv_path.write_text("\n".join(rows) + "\n")
    return str(csv_path)


def test_csv_dataset_columns_and_len(tmp_path):
    path = _write_corpus(tmp_path, n=7)
    ds = CsvPairDataset(path)
    assert len(ds) == 7
    img, cap = ds[3]
    assert img.endswith("img3.jpg") and cap == "caption number 3"
    with pytest.raises(ValueError):
        CsvPairDataset(path, img_key="nope")


def test_csv_dataset_comma_separator(tmp_path):
    path = _write_corpus(tmp_path, n=4, sep=",", img_key="image",
                         caption_key="text")
    ds = CsvPairDataset(path, img_key="image", caption_key="text", sep=",")
    assert len(ds) == 4


def test_csv_batches_match_reference_preprocess(tmp_path):
    path = _write_corpus(tmp_path, n=6)
    ds = CsvPairDataset(path)
    tok = get_tokenizer()
    batches = list(csv_batches(ds, 3, 32, tok, shuffle=False, seed=0))
    assert len(batches) == 2
    assert batches[0]["images"].shape == (3, 32, 32, 3)
    assert batches[0]["texts"].shape == (3, 77)
    # slot 0 must equal the per-image PIL eval transform exactly
    ref = preprocess_clip(ds.images[0], 32)
    np.testing.assert_allclose(batches[0]["images"][0], ref, rtol=0, atol=1e-5)


def test_csv_batches_epoch_shuffle_deterministic(tmp_path):
    path = _write_corpus(tmp_path, n=8)
    ds = CsvPairDataset(path)
    tok = get_tokenizer()

    def text_order(epoch):
        # position 3 holds the per-caption number token (SOT caption number N)
        return np.concatenate([
            b["texts"][:, 3] for b in
            csv_batches(ds, 4, 32, tok, epoch=epoch, seed=1)
        ])

    np.testing.assert_array_equal(text_order(0), text_order(0))
    assert not np.array_equal(text_order(0), text_order(1))


@pytest.mark.slow
def test_train_cli_csv_and_auto(tmp_path):
    from clip_embeds.cli.train import main

    path = _write_corpus(tmp_path, n=16)
    for ds_type in ("csv", "auto"):
        state = main([
            "--model", "test-tiny", "--dataset-type", ds_type,
            "--train-data", path, "--batch-size", "8", "--epochs", "1",
            "--precision", "fp32", "--log-every", "1",
        ])
        assert int(state.step) == 2


@pytest.mark.slow
def test_train_cli_webdataset(tmp_path):
    from clip_embeds.cli.train import main

    rng = np.random.default_rng(1)
    tar_path = tmp_path / "shard-000.tar"
    with tarfile.open(tar_path, "w") as tf:
        for i in range(16):
            buf = io.BytesIO()
            Image.fromarray(
                rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
            ).save(buf, format="JPEG", quality=90)
            for ext, data in (("jpg", buf.getvalue()),
                              ("txt", f"caption {i}".encode())):
                info = tarfile.TarInfo(f"{i:04d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    state = main([
        "--model", "test-tiny", "--dataset-type", "webdataset",
        "--train-data", str(tar_path), "--train-num-samples", "16",
        "--batch-size", "8", "--epochs", "1",
        "--precision", "fp32", "--log-every", "1",
    ])
    assert int(state.step) == 2


def test_build_data_varies_order_across_epochs(tmp_path):
    """cli.train.build_data must thread the epoch into the shuffle (epochs
    previously all reused the epoch-0 order)."""
    import argparse

    from clip_embeds.cli.train import build_data
    from clip_embeds.core.factory import create_model

    path = _write_corpus(tmp_path, n=8)
    model, _ = create_model("test-tiny")
    args = argparse.Namespace(
        dataset_type="csv", train_data=[path], batch_size=4, seed=0,
        csv_img_key="filepath", csv_caption_key="title", csv_separator="\t",
    )

    def order(epoch):
        it, _ = build_data(args, model.cfg, epoch=epoch)
        return np.concatenate([b["texts"][:, 3] for b in it])

    assert not np.array_equal(order(0), order(1))
    np.testing.assert_array_equal(order(1), order(1))
