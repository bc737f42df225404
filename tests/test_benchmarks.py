"""Benchmark dataset classes + zero-shot classifier tests."""

import pytest
import json
import os

import numpy as np
from PIL import Image

from clip_embeds.evals.benchmarks import (
    SugarCREPE,
    Winoground,
    get_benchmark,
    run_benchmark,
)
from clip_embeds.evals.zero_shot import (
    build_zero_shot_classifier,
    zero_shot_eval,
)
from clip_embeds.scores.score import Score


def _img(tmp_path, name, seed=0):
    rng = np.random.default_rng(seed)
    path = tmp_path / name
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 255, (20, 20, 3), dtype=np.uint8)).save(path)
    return str(path)


def test_winoground_dataset(tmp_path):
    os.makedirs(tmp_path / "images")
    rows = []
    for i in range(4):
        _img(tmp_path, f"images/ex_{i}_img_0.png", i)
        _img(tmp_path, f"images/ex_{i}_img_1.png", i + 100)
        rows.append({
            "image_0": f"ex_{i}_img_0", "image_1": f"ex_{i}_img_1",
            "caption_0": f"caption zero {i}", "caption_1": f"caption one {i}",
        })
    with open(tmp_path / "examples.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows))

    ds = get_benchmark("winoground", str(tmp_path))
    assert len(ds) == 4
    assert len(ds[0]["images"]) == 2 and len(ds[0]["texts"]) == 2

    # perfect scorer: image i matches caption i
    def pair_forward(images, texts):
        out = []
        for img, txt in zip(images, texts):
            img_idx = 0 if "img_0" in img else 1
            txt_idx = 0 if "zero" in txt else 1
            out.append(1.0 if img_idx == txt_idx else 0.0)
        return np.asarray(out, np.float32)

    tensor, metrics = run_benchmark(Score(pair_forward), ds, batch_size=2)
    assert tensor.shape == (4, 2, 2)
    assert metrics == {"text": 1.0, "image": 1.0, "group": 1.0}


def test_sugarcrepe_dataset(tmp_path):
    os.makedirs(tmp_path / "images")
    data = {}
    for i in range(3):
        _img(tmp_path, f"images/{i}.jpg", i)
        data[str(i)] = {
            "filename": f"{i}.jpg",
            "caption": f"a real caption {i}",
            "negative_caption": f"a fake caption {i}",
        }
    with open(tmp_path / "swap_obj.json", "w") as f:
        json.dump(data, f)

    ds = SugarCREPE(str(tmp_path))
    assert len(ds) == 3

    def pair_forward(images, texts):
        return np.asarray(
            [1.0 if "real" in t else 0.0 for t in texts], np.float32
        )

    _, metrics = run_benchmark(Score(pair_forward), ds)
    assert metrics["text"] == 1.0
    assert metrics["text/swap_obj"] == 1.0


def test_missing_root_is_empty(tmp_path):
    ds = Winoground(str(tmp_path / "nope"))
    assert not ds.exists()
    assert len(ds) == 0


def test_zero_shot_classifier():
    rng = np.random.default_rng(0)
    # fake encoder: hash class word to a direction
    dim = 16

    def encode_texts(prompts):
        out = np.zeros((len(prompts), dim), np.float32)
        for i, p in enumerate(prompts):
            r = np.random.default_rng(abs(hash(p.split()[-1])) % 2**31)
            out[i] = r.standard_normal(dim)
        return out / np.linalg.norm(out, axis=-1, keepdims=True)

    classifier = build_zero_shot_classifier(
        encode_texts, ["cat", "dog", "car"], num_classes_per_batch=2
    )
    assert classifier.shape == (dim, 3)
    np.testing.assert_allclose(
        np.linalg.norm(classifier, axis=0), 1.0, rtol=1e-5
    )

    def encode_images(batch):
        # images ARE class indices here; return the class column + noise
        return np.stack([
            classifier[:, int(i)] + 0.01 * rng.standard_normal(dim)
            for i in batch
        ]).astype(np.float32)

    metrics = zero_shot_eval(
        encode_images, classifier, [0, 1, 2, 0, 1], [0, 1, 2, 0, 1],
        batch_size=2,
    )
    assert metrics["top1"] == 1.0


def test_naturalbench_and_seetrue(tmp_path):
    import json as _json

    from clip_embeds.evals.benchmarks import (
        NaturalBenchRetrieval,
        SeeTrue,
    )

    os.makedirs(tmp_path / "images")
    meta = []
    for i in range(3):
        _img(tmp_path, f"images/a{i}.jpg", i)
        _img(tmp_path, f"images/b{i}.jpg", i + 50)
        meta.append({
            "index": i, "image_0": f"a{i}.jpg", "image_1": f"b{i}.jpg",
            "caption_0": f"cap zero {i}", "caption_1": f"cap one {i}",
        })
    (tmp_path / "metadata.json").write_text(_json.dumps(meta))
    ds = NaturalBenchRetrieval(str(tmp_path))
    assert len(ds) == 3

    def pair_forward(images, texts):
        return np.asarray([
            1.0 if (("a" in os.path.basename(i)) == ("zero" in t)) else 0.0
            for i, t in zip(images, texts)
        ], np.float32)

    _, m = run_benchmark(Score(pair_forward), ds)
    assert m == {"text": 1.0, "image": 1.0, "group": 1.0}

    rows = [
        {"image": f"a{i}.jpg", "text": f"caption {i}", "label": i % 2,
         "source": "coco"}
        for i in range(4)
    ]
    (tmp_path / "seetrue.json").write_text(_json.dumps(rows))
    st = SeeTrue(str(tmp_path))

    def st_forward(images, texts):
        return np.asarray(
            [0.9 if int(t.split()[-1]) % 2 else 0.1 for t in texts], np.float32
        )

    _, m = run_benchmark(Score(st_forward), st)
    assert m["accuracy"] == 1.0
    assert m["accuracy/coco"] == 1.0


def test_genai_bench(tmp_path):
    import json as _json

    from clip_embeds.evals.benchmarks import GenAIBench

    os.makedirs(tmp_path / "images")
    meta = {}
    rng = np.random.default_rng(9)
    for i in range(8):
        _img(tmp_path, f"images/{i}.jpg", i)
        meta[f"{i:05d}"] = {
            "image": f"{i}.jpg", "prompt": f"prompt {i}",
            "human_alignment": [1 + i % 5, 1 + i % 5],
            "prompt_idx": i,
        }
    (tmp_path / "metadata.json").write_text(_json.dumps(meta))
    (tmp_path / "genai_skills.json").write_text(
        _json.dumps({"basic": [0, 1, 2, 3], "advanced": [4, 5, 6, 7]})
    )
    ds = GenAIBench(str(tmp_path))
    assert len(ds) == 8

    # perfect metric == human rating
    def pair_forward(images, texts):
        return np.asarray(
            [1 + int(t.split()[-1]) % 5 for t in texts], np.float32
        )

    tensor, m = run_benchmark(Score(pair_forward), ds)
    assert m["alignment"]["pairwise_acc"] == 1.0
    per_skill = ds.evaluate_scores_per_skill(tensor)
    assert set(per_skill) == {"basic", "advanced"}


def _img_name(tmp_path, name):
    """Write a tiny image under tmp_path, return its RELATIVE name."""
    _img(tmp_path, name)
    return name


def test_pickapic(tmp_path):
    import json as _json

    from clip_embeds.evals.benchmarks import Pickapic

    n = max(Pickapic.SELECTED_IDXS) + 1
    img = _img_name(tmp_path, "i.png")
    rows = [{"id": i, "caption": f"cap {i}", "label_0": i % 2,
             "label_1": 1 - i % 2, "image_0": img, "image_1": img}
            for i in range(n)]
    (tmp_path / "test_captions.json").write_text(_json.dumps(rows))
    ds = Pickapic(str(tmp_path))
    assert len(ds) == 100
    # score image_0 higher always -> correct exactly when label_0 == 1
    scores = np.zeros((len(ds), 2, 1), np.float32)
    scores[:, 0, 0] = 1.0
    m = ds.evaluate_scores(scores)
    expect = np.mean([r["label_0"] == 1
                      for r in (rows[i] for i in Pickapic.SELECTED_IDXS)])
    assert abs(m["accuracy"] - expect) < 1e-9


def test_flickr30k_p(tmp_path):
    from clip_embeds.evals.benchmarks import Flickr30KNeg

    img = _img_name(tmp_path, "a.png")
    lines = ["images\tneg_images\tcaptions\tneg_captions"]
    for i in range(4):
        lines.append(f"{img}\t{img}\tleft {i}\tright {i}")
    (tmp_path / "metadata.tsv").write_text("\n".join(lines))
    ds = Flickr30KNeg(str(tmp_path))
    assert len(ds) == 4
    # c0 wins on i0 but c1 loses on i1 -> individual 0.5, text 0
    scores = np.zeros((4, 2, 2), np.float32)
    scores[:, 0, 0] = 2.0  # c0_i0
    scores[:, 0, 1] = 1.0  # c1_i0
    scores[:, 1, 0] = 2.0  # c0_i1
    scores[:, 1, 1] = 1.0  # c1_i1
    m = ds.evaluate_scores(scores)
    assert m["text"] == 0.0 and m["individual"] == 0.5


def test_tifa_and_flickr8k_cf(tmp_path):
    import json as _json

    from clip_embeds.evals.benchmarks import TIFA160, Flickr8KCF

    (tmp_path / "images").mkdir()
    img = _img_name(tmp_path / "images", "x.png")
    meta = {f"k{i}": {"text": f"t {i}", "image_path": img,
                      "human_avg": 1.0 + i}
            for i in range(6)}
    (tmp_path / "metadata.json").write_text(_json.dumps(meta))
    ds = TIFA160(str(tmp_path))
    scores = (1.0 + np.arange(6)).reshape(6, 1, 1)
    m = ds.evaluate_scores(scores)  # perfectly correlated
    assert abs(m["pearson"] - 1.0) < 1e-9
    assert m["pairwise_acc"] == 1.0

    cf = {
        "im1": {"image_path": img if False else "images/x.png",
                "ground_truth": ["a"],
                "human_judgement": [
                    {"caption": "good one", "rating": 3.0},
                    {"caption": "bad one", "rating": 1.0},
                ]},
        "im2": {"image_path": "images/x.png", "ground_truth": ["b"],
                "human_judgement": [{"caption": "mid", "rating": 2.0}]},
    }
    (tmp_path / "crowdflower_flickr8k.json").write_text(_json.dumps(cf))
    ds2 = Flickr8KCF(str(tmp_path))
    assert len(ds2) == 3
    m2 = ds2.evaluate_scores(np.asarray([3.0, 1.0, 2.0]).reshape(3, 1, 1))
    assert abs(m2["pearson"] - 1.0) < 1e-9


def test_frame_averaged_and_ranking(tmp_path):
    import json as _json

    from clip_embeds.evals.benchmarks import (
        GenAIBenchRanking,
        T2VScore,
    )

    img = _img_name(tmp_path, "f.png")
    videos = [{"frames": [img, img], "prompt": f"p {i}",
               "human_alignment": [1 + i, 1 + i]} for i in range(5)]
    (tmp_path / "metadata.json").write_text(_json.dumps(videos))
    ds = T2VScore(str(tmp_path))
    assert len(ds) == 5
    scores = np.stack([np.full((2, 1), 1.0 + i) for i in range(5)])
    m = ds.evaluate_scores(scores)
    assert abs(m["alignment"]["pearson"] - 1.0) < 1e-9

    # ranking: 2 prompts x 9 images
    rating = {
        str(p): {"id": str(p), "prompt": f"pr {p}", "models": {
            "DALLE_3": {str(i): [float(i)] for i in range(1, 10)}
        }} for p in range(2)
    }
    root = tmp_path / "rank"
    (root / "DALLE_3").mkdir(parents=True)
    (root / "human_rating.json").write_text(_json.dumps(rating))
    ds2 = GenAIBenchRanking(str(root))
    assert len(ds2) == 18
    ours = np.tile(np.arange(1, 10, dtype=np.float32), 2).reshape(18, 1, 1)
    m2 = ds2.evaluate_scores(ours)
    assert m2["ranking_accuracy"] == 1.0
    assert abs(m2["pearson"] - 1.0) < 1e-9


def test_imagenet_zero_shot_metadata():
    from clip_embeds.evals.zero_shot import (
        build_zero_shot_classifier,
        load_imagenet_metadata,
    )

    meta = load_imagenet_metadata()
    assert len(meta["IMAGENET_CLASSNAMES"]) == 1000
    assert len(meta["OPENAI_IMAGENET_TEMPLATES"]) == 80
    assert meta["IMAGENET_CLASSNAMES"][0] == "tench"
    assert "{c}" in meta["OPENAI_IMAGENET_TEMPLATES"][0]

    # the string templates drive the classifier builder directly
    def fake_encode(prompts):
        rng = np.random.default_rng(len(prompts))
        e = rng.standard_normal((len(prompts), 8))
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    clf = build_zero_shot_classifier(
        fake_encode, meta["IMAGENET_CLASSNAMES"][:5],
        meta["OPENAI_IMAGENET_TEMPLATES"][:4],
    )
    assert clf.shape == (8, 5)
    np.testing.assert_allclose(np.linalg.norm(clf, axis=0), 1.0, rtol=1e-6)


@pytest.mark.slow
def test_t2v_eval_cli_end_to_end(tmp_path):
    """cli/t2v_eval: CLIPScore over winoground + sugarcrepe fixtures."""
    import json as _json

    from clip_embeds.cli.t2v_eval import main
    from clip_embeds.evals.benchmarks import BENCHMARKS, get_benchmark

    # every dataset class is CLI-addressable
    assert len(BENCHMARKS) == 15

    os.makedirs(tmp_path / "images")
    rows = []
    for i in range(2):
        _img(tmp_path, f"images/ex_{i}_img_0.png", i)
        _img(tmp_path, f"images/ex_{i}_img_1.png", i + 50)
        rows.append({
            "image_0": f"ex_{i}_img_0", "image_1": f"ex_{i}_img_1",
            "caption_0": f"caption zero {i}", "caption_1": f"caption one {i}",
        })
    (tmp_path / "examples.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows)
    )
    data = {}
    for i in range(2):
        _img(tmp_path, f"images/{i}.jpg", i)
        data[str(i)] = {"filename": f"{i}.jpg", "caption": f"real {i}",
                        "negative_caption": f"fake {i}"}
    (tmp_path / "swap_obj.json").write_text(json.dumps(data))

    out = tmp_path / "results.json"
    rc = main([
        "--model", "test-tiny", "--root_dir", str(tmp_path),
        "--datasets", "winoground", "sugarcrepe", "tifa160_dsg",
        "--precision", "fp32", "--batch_size", "4",
        "--output", str(out),
    ])
    assert rc == 0
    results = _json.load(open(out))
    # tifa160 data missing -> skipped; the other two produced metrics
    assert set(results) == {"winoground", "sugarcrepe"}
    assert "group" in results["winoground"]


def test_download_benchmark_hooks(tmp_path, monkeypatch):
    """Gated auto-download (reference t2v_metrics/dataset.py:283-291 first-
    use gdown/unzip): refused by default under zero egress, runs with an
    injected fetcher, and get_benchmark(download=True) self-provisions."""
    import zipfile

    from clip_embeds.evals.benchmarks import (
        DOWNLOAD_SOURCES,
        download_benchmark,
    )

    monkeypatch.delenv("CLIP_EMBEDS_ALLOW_DOWNLOAD", raising=False)
    with pytest.raises(RuntimeError, match="zero-egress"):
        download_benchmark("winoground", str(tmp_path / "w"))
    with pytest.raises(KeyError):
        download_benchmark("not-a-benchmark", str(tmp_path / "x"))

    # injected fetcher: write a tiny winoground root as the 'archive'
    fetched = {}

    def fake_fetch(url, dest):
        fetched["url"] = url
        rng = np.random.default_rng(0)
        img_dir = tmp_path / "stage" / "images"
        os.makedirs(img_dir, exist_ok=True)
        rows = []
        for i in range(2):
            for s in ("0", "1"):
                Image.fromarray(rng.integers(
                    0, 255, (16, 16, 3), dtype=np.uint8)
                ).save(img_dir / f"ex_{i}_img_{s}.png")
            rows.append({"id": i, "image_0": f"ex_{i}_img_0",
                         "image_1": f"ex_{i}_img_1",
                         "caption_0": f"cap a {i}", "caption_1": f"cap b {i}"})
        with zipfile.ZipFile(dest, "w") as zf:
            for i in range(2):
                for s in ("0", "1"):
                    name = f"images/ex_{i}_img_{s}.png"
                    zf.write(tmp_path / "stage" / name, name)
            zf.writestr("examples.jsonl",
                        "\n".join(json.dumps(r) for r in rows))

    root = tmp_path / "wino"
    download_benchmark("winoground", str(root), fetch=fake_fetch)
    assert fetched["url"] == DOWNLOAD_SOURCES["winoground"][0]
    ds = get_benchmark("winoground", str(root))
    assert len(ds) == 2 and len(ds[0]["images"]) == 2

    # the gated env flag enables the real (urllib) path; with the archive
    # already present no network touch happens — extraction only
    monkeypatch.setenv("CLIP_EMBEDS_ALLOW_DOWNLOAD", "1")
    download_benchmark("winoground", str(root))
    assert get_benchmark("winoground", str(root), download=True).exists()
