"""Score API, metrics, and LoRA tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_embeds.evals.metrics import (
    get_scores,
    retrieval_metrics,
    winoground_accuracy,
    winoground_scores,
    zero_shot_accuracy,
)
from clip_embeds.scores.score import Score


def test_get_scores_perfect():
    # q0 matches i0, q1 matches i1
    results = [[1.0, 0.0, 0.0, 1.0]] * 5
    s = get_scores(results)
    assert s == {
        "question_score": 1.0, "image_score": 1.0,
        "binary_score": 1.0, "group_score": 1.0,
    }


def test_get_scores_mixed():
    results = [
        [1.0, 0.0, 0.0, 1.0],  # all correct
        [1.0, 1.0, 1.0, 1.0],  # yes-bias: binary half right, others 0
    ]
    s = get_scores(results)
    assert s["question_score"] == 0.5
    assert s["image_score"] == 0.5
    assert s["binary_score"] == 0.75
    assert s["group_score"] == 0.5

    # dict form agrees with list form
    as_dicts = {
        i: dict(zip(["q0_i0", "q0_i1", "q1_i0", "q1_i1"], r))
        for i, r in enumerate(results)
    }
    assert get_scores(as_dicts) == s


def test_winoground_metrics():
    # scores_i2t[image][caption]; c0<->i0 and c1<->i1 correct
    good = np.asarray([[[0.9, 0.1], [0.2, 0.8]]])
    scores = winoground_scores(good)
    acc = winoground_accuracy(scores)
    assert acc == {"text": 1.0, "image": 1.0, "group": 1.0}

    # text correct but image wrong: c0_i0 > c1_i0 and c1_i1 > c0_i1,
    # but c0_i1 > c0_i0
    mixed = np.asarray([[[0.5, 0.1], [0.8, 0.9]]])
    acc = winoground_accuracy(winoground_scores(mixed))
    assert acc["text"] == 1.0 and acc["image"] == 0.0 and acc["group"] == 0.0


def test_retrieval_metrics_identity():
    feats = np.eye(12, 16, dtype=np.float32)
    m = retrieval_metrics(feats, feats)
    assert m["image_to_text_R@1"] == 1.0
    assert m["text_to_image_R@5"] == 1.0
    assert m["image_to_text_mean_rank"] == 1.0


def test_zero_shot_accuracy():
    logits = np.asarray([[0.9, 0.05, 0.05], [0.2, 0.1, 0.7], [0.4, 0.5, 0.1]])
    targets = np.asarray([0, 2, 0])
    acc = zero_shot_accuracy(logits, targets, topk=(1, 2))
    assert acc["top1"] == pytest.approx(2 / 3)
    assert acc["top2"] == 1.0


def test_score_api_mxn():
    calls = []

    def pair_forward(images, texts):
        calls.append((list(images), list(texts)))
        return np.asarray([len(t) for t in texts], np.float32)

    score = Score(pair_forward)
    out = score(["img_a", "img_b"], ["x", "yy", "zzz"])
    assert out.shape == (2, 3)
    np.testing.assert_array_equal(out[0], [1, 2, 3])
    # image repeated per text (reference score.py:55-57)
    assert calls[0][0] == ["img_a", "img_a", "img_a"]


def test_score_batch_forward():
    def pair_forward(images, texts):
        return np.asarray(
            [float(i == t) for i, t in zip(images, texts)], np.float32
        )

    score = Score(pair_forward)
    dataset = [
        {"images": ["0", "1"], "texts": ["0", "1"]} for _ in range(5)
    ]
    out = score.batch_forward(dataset, batch_size=2)
    assert out.shape == (5, 2, 2)
    np.testing.assert_array_equal(out[0], [[1, 0], [0, 1]])


def test_lora_roundtrip():
    from clip_embeds.models.lora import init_lora, materialize, merge_lora

    params = {
        "language_model": {
            "model": {
                "layers_0": {
                    "self_attn": {
                        "q_proj": {"kernel": np.ones((8, 8), np.float32)},
                        "o_proj": {"kernel": np.ones((8, 8), np.float32)},
                    },
                },
            },
        },
        "vision_tower": {
            "transformer": {
                "resblocks_0": {
                    "attn": {
                        "q_proj": {"kernel": np.ones((8, 8), np.float32)},
                    }
                }
            }
        },
    }
    lora = init_lora(params, rank=2, rng=jax.random.PRNGKey(0))
    keys = set(lora)
    assert any("q_proj" in k and "language_model" in k for k in keys)
    # vision tower excluded (reference exclude_modules='.*vision_tower.*')
    assert not any("vision_tower" in k for k in keys)

    # b=0 at init -> materialize == base
    merged = materialize(params, lora, alpha=16.0, train=False)
    np.testing.assert_array_equal(
        np.asarray(jax.tree.leaves(merged)[0]),
        np.asarray(jax.tree.leaves(params)[0]),
    )

    # nonzero b shifts only targeted kernels
    key = next(k for k in keys)
    lora[key]["b"] = jnp.ones_like(lora[key]["b"])
    merged = merge_lora(params, lora, alpha=2.0)
    flat_m = dict(zip(
        ["/".join(str(getattr(p, "key", p)) for p in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(merged)[0]],
        jax.tree.leaves(merged),
    ))
    changed = flat_m[key]
    base_like = flat_m["vision_tower/transformer/resblocks_0/attn/q_proj/kernel"]
    assert not np.allclose(np.asarray(changed), 1.0)
    np.testing.assert_array_equal(np.asarray(base_like), 1.0)


def test_lora_gradients_only_adapters():
    from clip_embeds.models.lora import init_lora, materialize

    params = {"q_proj": {"kernel": np.ones((4, 4), np.float32)}}
    lora = init_lora(params, rank=2, exclude=())

    def loss(lora_tree, base):
        merged = materialize(base, lora_tree, alpha=4.0, train=True)
        return jnp.sum(merged["q_proj"]["kernel"] ** 2)

    g_lora = jax.grad(loss)(lora, params)
    assert np.abs(np.asarray(g_lora["q_proj/kernel"]["a"])).sum() >= 0  # exists
    g_base = jax.grad(lambda b: loss(lora, b))(params)
    np.testing.assert_array_equal(np.asarray(g_base["q_proj"]["kernel"]), 0.0)


def test_tau_optimization_matches_reference():
    """Compare against the reference implementation run as an oracle."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_ref_tau", "/root/reference/t2v_metrics/tau_optimization.py"
    )
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    from clip_embeds.evals.tau import TauStats, tau_optimization

    rng = np.random.default_rng(0)
    human = rng.integers(0, 4, (6, 8)).astype(float)
    metric = human + rng.normal(0, 0.8, (6, 8))

    ours = tau_optimization(metric, human, TauStats.acc_23)
    theirs = ref.tau_optimization(
        metric, human, ref.TauSufficientStats.acc_23
    )
    assert ours.best_threshold == pytest.approx(theirs.best_threshold)
    assert ours.best_tau == pytest.approx(theirs.best_tau)
    np.testing.assert_allclose(ours.taus, theirs.taus)


def test_tau_optimization_perfect_metric():
    from clip_embeds.evals.tau import TauStats, tau_optimization

    human = np.asarray([[1.0, 2.0, 3.0, 4.0]])
    res = tau_optimization(human, human, TauStats.acc_23)
    assert res.best_tau == 1.0
    assert res.best_threshold == 0.0


def test_kendall_variants_vs_reference():
    import importlib.util

    # reference KendallVariants lives in dataset.py which imports heavy deps;
    # use scipy as the independent oracle for tau-b instead
    from scipy import stats

    from clip_embeds.evals.tau import correlation_metrics, kendall_variants

    rng = np.random.default_rng(3)
    gold = rng.integers(0, 5, 30).astype(float)
    metric = gold + rng.normal(0, 1.0, 30)

    ours = kendall_variants(gold, metric, "b")
    expected = stats.kendalltau(metric, gold, variant="b").statistic
    assert ours == pytest.approx(expected)

    bundle = correlation_metrics(gold, metric)
    assert set(bundle) == {"pearson", "kendall_b", "pairwise_acc",
                           "pairwise_acc_threshold"}
    assert -1 <= bundle["kendall_b"] <= 1
    assert 0 <= bundle["pairwise_acc"] <= 1


@pytest.mark.slow
def test_score_model_name_registry():
    """t2v get_score_model dispatch surface: name lists + CLIP-family build."""
    import pytest as _pytest

    from clip_embeds.scores.registry import (
        get_score_model,
        list_all_clipscore_models,
        list_all_models,
        list_all_vqascore_models,
    )

    vqa = list_all_vqascore_models()
    assert "llava-v1.5-7b" in vqa and "clip-flant5-xxl" in vqa
    assert "gpt-4o" in vqa and "instructblip-flant5-xl" in vqa

    clipscore = list_all_clipscore_models()
    assert "openai:ViT-L-14-336" in clipscore    # reference tag:arch format
    assert "blip2-itc" in clipscore and "hpsv2" in clipscore
    assert len(clipscore) >= 180

    assert len(list_all_models()) == len(clipscore) + len(vqa) + 4  # 3 blip2-itm + image-reward

    # CLIP family builds a live Score (random init without weights)
    score = get_score_model("openai:test-tiny")
    import numpy as np
    from PIL import Image

    img = Image.fromarray(np.zeros((20, 20, 3), np.uint8))
    out = score([img], ["a cat", "a dog"])
    assert np.asarray(out).shape == (1, 2)

    with _pytest.raises(NotImplementedError):
        get_score_model("llava-v1.5-7b")
    with _pytest.raises(KeyError):
        get_score_model("not-a-model")
