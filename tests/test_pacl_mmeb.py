"""PACL caption data sampling + MMEB eval protocol tests."""

import json

import numpy as np
from PIL import Image

from clip_embeds.data.pacl_data import (
    CaptionPromptSampler,
    PACLCaptionDataset,
    pacl_batches,
    regex_noun_phrases,
)
from clip_embeds.evals.mmeb import dedup_pairs, evaluate_subset


def test_regex_noun_phrases():
    phrases = regex_noun_phrases("A small dog sitting on the wooden table")
    assert any("dog" in p for p in phrases)
    assert any("table" in p for p in phrases)


def test_prompt_sampler_mixes():
    sampler = CaptionPromptSampler(seed=0)
    caption = "A red bicycle leaning against the old wall"
    outputs = {sampler(caption) for _ in range(40)}
    # some outputs are templated noun phrases, some the raw caption
    assert caption in outputs
    assert any(o != caption for o in outputs)
    templated = [o for o in outputs if o != caption]
    assert all(any(t in o for t in ("picture", "photo", "itap", "contains"))
               for o in templated)


def test_pacl_dataset_with_embeddings(tmp_path):
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    ann = []
    for i in range(6):
        name = f"{i}.jpg"
        Image.fromarray(
            rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
        ).save(img_dir / name)
        ann.append({
            "image": name,
            "conversations": [
                {"from": "human", "value": "<image>\nDescribe."},
                {"from": "gpt", "value": f"A photo of a blue chair number {i}"},
            ],
        })
    ann_path = tmp_path / "ann.json"
    ann_path.write_text(json.dumps(ann))
    embeds = rng.standard_normal((6, 16)).astype(np.float32)
    np.save(tmp_path / "embeds.npy", embeds)

    ds = PACLCaptionDataset(
        [str(ann_path)], [str(img_dir)], image_size=32,
        embed_paths=[str(tmp_path / "embeds.npy")],
    )
    pixels, prompt, emb = ds.get(2)
    assert pixels.shape == (32, 32, 3)
    assert isinstance(prompt, str) and len(prompt) > 0
    np.testing.assert_array_equal(emb, embeds[2])

    batches = list(pacl_batches(ds, batch_size=3, num_workers=2))
    assert len(batches) == 2
    assert batches[0]["images"].shape == (3, 32, 32, 3)
    assert batches[0]["texts"].shape == (3, 77)
    assert batches[0]["text_embeddings"].shape == (3, 16)


def test_mmeb_protocol(tmp_path):
    # 4 queries, gold target first; encoders hash pair -> direction
    dim = 8

    def direction(key):
        r = np.random.default_rng(abs(hash(key)) % 2**31)
        v = r.standard_normal(dim)
        return v / np.linalg.norm(v)

    rows = []
    for i in range(4):
        gold = f"answer {i}"
        rows.append({
            "qry_text": f"question {i}", "qry_img_path": f"img{i}.jpg",
            "tgt_text": [gold, f"answer {i+10}", f"answer {i+20}"],
            "tgt_img_path": ["", "", ""],
        })

    def encode_queries(pairs):
        # perfect model: query embedding == its gold answer embedding
        return np.stack([direction(f"answer {p[0].split()[-1]}") for p in pairs])

    def encode_targets(pairs):
        return np.stack([direction(p[0]) for p in pairs])

    result = evaluate_subset(
        rows, encode_queries, encode_targets, cache_dir=str(tmp_path),
        subset="toy",
    )
    assert result["acc"] == 1.0

    # cache round-trip: second call reuses pickles
    result2 = evaluate_subset(
        rows, encode_queries, encode_targets, cache_dir=str(tmp_path),
        subset="toy",
    )
    assert result2 == result

    assert dedup_pairs([("a", ""), ("a", ""), ("b", "")]) == [("a", ""), ("b", "")]
