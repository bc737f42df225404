"""Data pipeline tests: hard negatives, datamix batching, checkpointing."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from clip_embeds.data.hard_negatives import (
    HardNegativeAugmenter,
    leftright_augmenter,
)


def test_leftright_swaps():
    aug = leftright_augmenter(seed=0)
    assert aug("a mug on the left of the table") == "a mug on the right of the table"
    assert aug("a dog to the right of a cat") == "a dog to the left of a cat"
    assert aug("a plain caption with no spatial words") is None


def test_word_mode_swaps_all():
    aug = HardNegativeAugmenter({"left": ["right"], "up": ["down"]})
    assert not aug.phrases
    assert aug("move Left then up") == "move right then down"  # lowercased match
    assert aug("nothing here") is None


def _make_datamix(tmp_path, n=10):
    img_dir = tmp_path / "lcs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    annotations = []
    for i in range(n):
        name = f"0{i:04d}.jpg"
        Image.fromarray(
            rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
        ).save(img_dir / name)
        caption = (
            f"A photo of object {i} on the left of the shelf"
            if i % 2 == 0 else f"A photo of object {i} with nothing spatial"
        )
        annotations.append({
            "id": str(i),
            "image": name,
            "conversations": [
                {"from": "human", "value": "<image>\nDescribe."},
                {"from": "gpt", "value": caption},
            ],
        })
    # one sample without an image must be filtered (reference data.py:33-36)
    annotations.append({"id": "x", "conversations": []})
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(annotations))
    return ann_path, img_dir


def test_datamix_batches(tmp_path):
    from clip_embeds.data.datamix import DataMixDataset, datamix_batches

    ann, img_dir = _make_datamix(tmp_path)
    ds = DataMixDataset(
        [str(ann)],
        {"lcs558k": str(img_dir), "datamix665k": str(img_dir)},
        image_size=32,
        augmenter=leftright_augmenter(seed=0),
    )
    assert len(ds) == 10  # image-less sample filtered

    batches = list(datamix_batches(ds, batch_size=4, max_hard_per_batch=4,
                                   shuffle=False, num_workers=2))
    assert len(batches) == 2  # drop_last
    b = batches[0]
    assert b["images"].shape == (4, 32, 32, 3)
    assert b["texts"].shape == (4, 77)
    assert b["hard_texts"].shape == (4, 77)
    assert b["hard_valid"].shape == (4,)
    # samples 0,2 in first batch have spatial captions -> 2 valid hard rows
    assert b["hard_valid"].sum() == 2
    # hard rows must differ from originals where valid
    assert not np.array_equal(b["hard_texts"][0], b["texts"][0])


def test_checkpoint_roundtrip(tmp_path):
    from clip_embeds.core import checkpoint as ckpt

    state = {
        "params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
        "step": np.asarray(3),
    }
    p1 = ckpt.save(str(tmp_path), state, step=1)
    state2 = {
        "params": {"w": np.ones((2, 3), np.float32)},
        "step": np.asarray(7),
    }
    p2 = ckpt.save(str(tmp_path), state2, step=2)

    latest = ckpt.latest_checkpoint(str(tmp_path))
    assert latest == p2
    assert ckpt.step_of(latest) == 2

    restored = ckpt.load(latest, target=state2)
    np.testing.assert_array_equal(restored["params"]["w"], state2["params"]["w"])

    resumed = ckpt.resume(str(tmp_path), target=state2)
    np.testing.assert_array_equal(resumed["params"]["w"], state2["params"]["w"])
    assert ckpt.resume(str(tmp_path / "empty")) is None


def test_checkpoint_prune(tmp_path):
    from clip_embeds.core import checkpoint as ckpt

    state = {"w": np.zeros(2, np.float32)}
    for step in range(5):
        ckpt.save(str(tmp_path), state, step=step, keep=2)
    names = sorted(os.listdir(tmp_path))
    steps = [ckpt.step_of(n) for n in names if n.startswith("epoch_")]
    assert sorted(steps) == [3, 4]


def test_remote_sync(tmp_path):
    from clip_embeds.core.remote_sync import RemoteSync, sync_once

    src = tmp_path / "src"
    dst = tmp_path / "dst"
    src.mkdir()
    (src / "ckpt.txt").write_text("v1")
    (src / "sub").mkdir()
    (src / "sub" / "log.txt").write_text("hello")

    assert sync_once(str(src), str(dst))
    assert (dst / "ckpt.txt").read_text() == "v1"
    assert (dst / "sub" / "log.txt").read_text() == "hello"

    # updated file gets re-synced; stop() does a final sync
    (src / "ckpt.txt").write_text("v2")
    rs = RemoteSync(str(src), str(dst), every_seconds=3600)
    rs.start()
    rs.stop(final_sync=True)
    assert (dst / "ckpt.txt").read_text() == "v2"


def test_regex_chunker_divergence_vs_gold_fixture():
    """Quantify the regex noun-chunker's divergence from spacy-convention
    chunks (the PACL training-data distribution depends on it). Gold annotations live in tests/fixtures/noun_chunks_gold.json; when
    spacy + en_core_web_sm are installed the fixture is cross-checked
    against the real pipeline too."""
    import json
    import os

    from clip_embeds.data.pacl_data import regex_noun_phrases

    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "noun_chunks_gold.json")
    gold = json.load(open(path))["samples"]

    head_hits = head_total = 0
    exact_hits = exact_total = 0
    for sample in gold:
        got = regex_noun_phrases(sample["caption"])
        got_text = " | ".join(got)
        for chunk in sample["chunks"]:
            exact_total += 1
            head = chunk.split()[-1]
            head_total += 1
            if chunk in got:
                exact_hits += 1
            if any(head in g.split() for g in got):
                head_hits += 1
    head_recall = head_hits / head_total
    exact_recall = exact_hits / exact_total
    # the PACL signal keys on object mentions: heads must survive chunking
    assert head_recall >= 0.9, (head_recall, "regex chunker lost NP heads")
    # exact-span agreement is the divergence being quantified; keep a floor
    # so regressions surface, and the measured value documents the gap
    assert exact_recall >= 0.5, exact_recall

    # self-checking fixture when the real pipeline is available
    try:
        import spacy

        nlp = spacy.load("en_core_web_sm")
    except Exception:
        return
    for sample in gold:
        spacy_chunks = [c.text.lower() for c in nlp(sample["caption"]).noun_chunks]
        assert spacy_chunks == sample["chunks"], sample["caption"]
