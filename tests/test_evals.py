"""Eval driver aggregation logic + end-to-end scorer runs on synthetic data."""

import csv
import json
import os

import numpy as np
import pytest
from PIL import Image

from clip_embeds.evals.mmvp import eval_mmvp
from clip_embeds.evals.whatsup import eval_coco_vg, eval_whatsup

PREPS_A = ["left_of", "right_of", "on", "under"]  # What'sUp A-style
KEYS = ["left", "right", "on", "under"]


def _make_whatsup_dataset(tmp_path, n_pairs=4):
    """Synthetic What'sUp-format dataset: n_pairs object pairs x 4 images."""
    img_dir = tmp_path / "controlled_images"
    img_dir.mkdir(exist_ok=True)
    dataset = []
    rng = np.random.default_rng(0)
    for p in range(n_pairs):
        o1, o2 = f"mug{p}", f"table{p}"
        for key in KEYS:
            name = f"{o1}_{key}_of_the_{o2}.jpeg"
            arr = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(img_dir / name)
            gt = f"A {o1} {key} of a {o2}" if key in ("left", "right") else (
                f"A {o1} {key} a {o2}"
            )
            opposite = {"left": "right", "right": "left", "on": "under",
                        "under": "on"}[key]
            distractor = gt.replace(key, opposite)
            # two extra options with other prepositions (filtered out for
            # 2-option eval; used for 4-option)
            others = [k for k in ("left", "right", "on", "under")
                      if k not in (key, opposite)]
            extra = [gt.replace(key, o) for o in others]
            dataset.append({
                "image_path": f"data/controlled_images/{name}",
                "caption_options": [gt, distractor] + extra,
            })
    return dataset


class PatternScorer:
    """Deterministic mock: sample i correct iff i in correct_set."""

    def __init__(self, correct_set):
        self.correct_set = correct_set
        self.calls = 0

    def score_batch(self, samples):
        out = []
        for i, (_, options) in enumerate(samples):
            scores = np.linspace(0.5, 0.1, len(options))
            if i not in self.correct_set:
                scores[0], scores[1] = scores[1], scores[0]
            out.append(scores)
            self.calls += 1
        return out


def test_whatsup_aggregation_all_correct(tmp_path):
    dataset = _make_whatsup_dataset(tmp_path)
    scorer = PatternScorer(set(range(len(dataset))))
    r = eval_whatsup(scorer.score_batch, dataset, str(tmp_path))
    assert r["individual_accuracy"] == 100.0
    # fixture has only lr+ou pairs; front/back contributes 0 to pair_correct,
    # and pair denominator is total/2, so all-correct lr+ou gives 100
    assert r["pair_accuracy"] == 100.0
    # each object pair has 4 correct entries (front/back keys stay 0 but the
    # sum over the 4 filled keys is 4) -> set accuracy 100
    assert r["set_accuracy"] == 100.0
    assert r["front_back_pair_accuracy"] == 0.0


def test_whatsup_aggregation_exact_counts(tmp_path):
    dataset = _make_whatsup_dataset(tmp_path, n_pairs=2)  # 8 samples
    # first object pair (samples 0-3) all correct; second all wrong
    scorer = PatternScorer({0, 1, 2, 3})
    r = eval_whatsup(scorer.score_batch, dataset, str(tmp_path))
    total = 8
    # individual: 4 correct of 8
    assert r["individual_accuracy"] == 4 * 100 / total
    # lr pair: 1 of 2; ou pair: 1 of 2 -> pair_correct=2, denom total/2=4
    assert r["pair_accuracy"] == 2 * 100 / (total / 2)
    # set: one object pair has all 4 -> 1, denom total/4 = 2
    assert r["set_accuracy"] == 1 * 100 / (total / 4)


def test_whatsup_4option(tmp_path):
    dataset = _make_whatsup_dataset(tmp_path, n_pairs=2)
    scorer = PatternScorer(set(range(len(dataset))))
    r = eval_whatsup(scorer.score_batch, dataset, str(tmp_path), four_option=True)
    assert r["individual_accuracy"] == 100.0


def test_coco_vg_driver(tmp_path):
    os.makedirs(tmp_path / "val2017", exist_ok=True)
    dataset = []
    rng = np.random.default_rng(1)
    for i, prep in enumerate(["left", "right", "above", "below"]):
        img_id = i + 1
        arr = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(arr).save(
            tmp_path / "val2017" / f"{str(img_id).zfill(12)}.jpg"
        )
        opposite = {"left": "right", "right": "left",
                    "above": "below", "below": "above"}[prep]
        dataset.append([
            img_id,
            f"A photo of a dog to the {prep} of a cat",
            f"A photo of a dog to the {opposite} of a cat",
        ])
    scorer = PatternScorer({0, 1})  # left/right correct, above/below wrong
    r = eval_coco_vg(scorer.score_batch, dataset, str(tmp_path), "coco")
    assert r["individual_accuracy"] == 50.0
    assert r["left_right_individual_accuracy"] == 100.0
    assert r["above_below_individual_accuracy"] == 0.0


def _make_mmvp(tmp_path, n_pairs=135):
    """MMVP-VLM-format fixture: the real 9 categories x 15 pairs structure
    (the reference bucketing hard-codes it, eval_clip.py:254-260,339-341)."""
    from clip_embeds.evals.mmvp import MMVP_VLM_CATEGORIES as cats
    img_dir = tmp_path / "MLLM_VLM_Images"
    rows = [["qid", "type", "statement"]]
    rng = np.random.default_rng(2)
    qid = 1
    for p in range(n_pairs):
        cat = cats[p // 15]
        os.makedirs(img_dir / cat, exist_ok=True)
        for _ in range(2):
            arr = rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)
            Image.fromarray(arr).save(img_dir / cat / f"{qid}.jpg")
            rows.append([str(qid), cat, f"statement number {qid}"])
            qid += 1
    with open(tmp_path / "Questions.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)


def test_mmvp_driver_parity_gt(tmp_path):
    _make_mmvp(tmp_path)

    def perfect_pair_score(images, texts):
        # statement k is about image (qid parity): qid odd -> img1
        qid1 = int(os.path.basename(images[0]).split(".")[0])
        m = np.zeros((2, 2))
        if qid1 % 2 == 1:
            m[0] = [0.9, 0.1]  # statement1 -> img1
            m[1] = [0.1, 0.9]  # statement2 -> img2
        else:
            m[0] = [0.1, 0.9]
            m[1] = [0.9, 0.1]
        return m

    r = eval_mmvp(perfect_pair_score, str(tmp_path), "mmvpvlm")
    assert r["pair_accuracy"] == 100.0
    assert r["individual_accuracy"] == 100.0
    assert r["pair_accuracy/Orientation and Direction"] == 100.0


def test_mmvp_driver_half(tmp_path):
    _make_mmvp(tmp_path)
    state = {"n": 0}

    def half_pair_score(images, texts):
        state["n"] += 1
        good = state["n"] % 2 == 1
        qid1 = int(os.path.basename(images[0]).split(".")[0])
        first = qid1 % 2 == 1
        m = np.zeros((2, 2))
        if first == good:
            m[0] = [0.9, 0.1]; m[1] = [0.1, 0.9]
        else:
            m[0] = [0.1, 0.9]; m[1] = [0.9, 0.1]
        return m

    r = eval_mmvp(half_pair_score, str(tmp_path), "mmvpvlm")
    # 135 pairs, odd-indexed calls correct -> 68 of 135
    expected = 68 * 100 / 135
    assert abs(r["pair_accuracy"] - expected) < 1e-9
    assert abs(r["individual_accuracy"] - expected) < 1e-9


def test_clip_scorer_end_to_end(tmp_path):
    """Full pipeline with the tiny model: driver + CLIPScorer on fixtures."""
    from clip_embeds.core.factory import create_model
    from clip_embeds.scores.scorers import CLIPScorer

    dataset = _make_whatsup_dataset(tmp_path, n_pairs=2)
    model, params = create_model("test-tiny", attn_impl="reference")
    scorer = CLIPScorer(model, params, batch_size=8)
    r = eval_whatsup(scorer.score_batch, dataset, str(tmp_path))
    for v in r.values():
        assert 0.0 <= v <= 100.0


def test_pacl_scorer_end_to_end(tmp_path):
    import jax
    import jax.numpy as jnp

    from clip_embeds.core.factory import create_model
    from clip_embeds.models.heads import PACLHead
    from clip_embeds.scores.scorers import PACLScorer

    dataset = _make_whatsup_dataset(tmp_path, n_pairs=1)
    model, params = create_model("test-tiny", attn_impl="reference")
    head = PACLHead(proj_dim=32)
    patches = jnp.zeros((1, model.cfg.vision.num_patches, model.cfg.vision.width))
    text_emb = jnp.zeros((1, model.cfg.embed_dim))
    head_params = head.init(jax.random.PRNGKey(0), patches, text_emb)["params"]
    scorer = PACLScorer(model, params, head, head_params, batch_size=4)
    r = eval_whatsup(scorer.score_batch, dataset, str(tmp_path))
    assert "individual_accuracy" in r


def test_flickr_retrieval(tmp_path):
    import json as _json

    from clip_embeds.evals.flickr import (
        evaluate_retrieval,
        load_flickr_annotations,
    )

    ann = [
        {"image": f"{i}.jpg", "captions": [f"cap {i} v{j}" for j in range(3)]}
        for i in range(5)
    ]
    (tmp_path / "annotations.json").write_text(_json.dumps(ann))
    loaded = load_flickr_annotations(str(tmp_path))
    assert len(loaded) == 5

    dim = 8

    def direction(i):
        r = np.random.default_rng(i)
        v = r.standard_normal(dim)
        return v / np.linalg.norm(v)

    def encode_images(paths):
        return np.stack([
            direction(int(os.path.basename(p).split(".")[0])) for p in paths
        ])

    def encode_texts(texts):
        return np.stack([direction(int(t.split()[1])) for t in texts])

    m = evaluate_retrieval(encode_images, encode_texts, loaded)
    assert m["text_to_image_R@1"] == 1.0
    assert m["image_to_text_R@1"] == 1.0
    assert m["mean_recall"] == 1.0
