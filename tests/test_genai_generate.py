"""GenAI-Bench generate->score workflow (cli/genai_generate.py shim).

Reference t2v_metrics/genai_bench/generate.py produces one image per prompt
with diffusers and saves <output>/<model>/<idx>.jpeg for evaluate.py to
score; the shim reproduces the loop with an injectable image source (no
diffusers/egress needed)."""

import json
import os

import numpy as np
import pytest


@pytest.fixture()
def prompts_json(tmp_path):
    prompts = {str(i): {"prompt": f"a photo of object {i}"}
               for i in range(6)}
    path = tmp_path / "genai_image.json"
    path.write_text(json.dumps(prompts))
    return str(path)


def test_generate_synthetic_layout(prompts_json, tmp_path):
    from clip_embeds.cli.genai_generate import main

    out = main([
        "--prompts", prompts_json, "--gen-model", "toy-model",
        "--output-dir", str(tmp_path / "outputs"),
        "--image-source", "synthetic", "--num-prompts", "5",
    ])
    files = sorted(os.listdir(out))
    assert files == [f"{i}.jpeg" for i in range(5)]


def test_generate_deterministic(prompts_json, tmp_path):
    from clip_embeds.cli.genai_generate import main

    a = main(["--prompts", prompts_json, "--gen-model", "m",
              "--output-dir", str(tmp_path / "a")])
    b = main(["--prompts", prompts_json, "--gen-model", "m",
              "--output-dir", str(tmp_path / "b")])
    for f in os.listdir(a):
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read()


def test_generate_then_score(prompts_json, tmp_path):
    """Full generate->score loop: shim output feeds the GenAIBench scoring
    dataset (evals/benchmarks.py) like the reference evaluate.py."""
    from clip_embeds.cli.genai_generate import main
    from clip_embeds.evals.benchmarks import GenAIBench

    out = main(["--prompts", prompts_json, "--gen-model", "toy",
                "--output-dir", str(tmp_path / "outputs")])

    root = tmp_path / "bench_root"
    (root / "images").mkdir(parents=True)
    meta = {}
    rng = np.random.default_rng(0)
    for i in range(6):
        os.link(os.path.join(out, f"{i}.jpeg"), root / "images" / f"{i}.jpeg")
        meta[str(i)] = {
            "image": f"{i}.jpeg",
            "prompt": f"a photo of object {i}",
            "human_alignment": rng.integers(1, 6, 3).tolist(),
        }
    (root / "metadata.json").write_text(json.dumps(meta))

    ds = GenAIBench(str(root))
    assert len(ds.samples) == 6
    for s in ds.samples:
        assert os.path.exists(s["images"][0])
    scores = rng.random(6)
    metrics = ds.evaluate_scores(scores)
    assert "alignment" in metrics and metrics["alignment"]
