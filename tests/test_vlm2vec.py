"""VLM2Vec training (LoRA + GradCache) and embedding-scorer tests."""

import json
import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds.core.config import VisionConfig
from clip_embeds.models.llama import LlamaConfig
from clip_embeds.models.llava import Llava, LlavaConfig
from clip_embeds.models.lora import init_lora
from clip_embeds.train.optim import adamw
from clip_embeds.train.steps import TrainState
from clip_embeds.train.vlm2vec import make_vlm2vec_train_step

pytestmark = pytest.mark.slow  # torch-oracle parity family (see pyproject)


def tiny_llava():
    cfg = LlavaConfig(
        llama=LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, max_position_embeddings=256,
        ),
        vision=VisionConfig(image_size=32, patch_size=16, width=64, layers=2,
                            head_width=32),
    )
    model = Llava(cfg, attn_impl="reference")
    ids = jnp.asarray([[1, 2, -200, 3]], jnp.int32)
    pixels = jnp.zeros((1, 32, 32, 3))
    params = model.init(jax.random.PRNGKey(0), ids, pixels)["params"]
    return model, params


def _toy_tokenize(text):
    return [1] + [2 + (sum(map(ord, w)) % 200) for w in text.split()]


def _batch(n=4, length=16):
    rng = np.random.default_rng(0)
    qry_ids = np.full((n, length), 0, np.int32)
    qry_mask = np.zeros((n, length), bool)
    tgt_ids = np.full((n, length), 0, np.int32)
    tgt_mask = np.zeros((n, length), bool)
    for i in range(n):
        L = rng.integers(6, length)
        qry_ids[i, :L] = rng.integers(1, 250, L)
        qry_ids[i, 2] = -200
        qry_mask[i, :L] = True
        Lt = rng.integers(4, length)
        tgt_ids[i, :Lt] = rng.integers(1, 250, Lt)
        tgt_mask[i, :Lt] = True
    return {
        "qry_ids": qry_ids, "qry_mask": qry_mask,
        "qry_pixels": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
        "tgt_ids": tgt_ids, "tgt_mask": tgt_mask,
    }


def test_vlm2vec_lora_training_step():
    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    assert lora, "no LoRA targets found"
    step = jax.jit(make_vlm2vec_train_step(model, base_params))
    state = TrainState.create(lora, adamw(1e-3, weight_decay=0.0))
    batch = _batch()
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    # base params untouched by construction (state holds only adapters)
    assert set(state.params) == set(lora)


def test_lora_layouts_and_merge_guard():
    """normalize_lora accepts all three adapter layouts that occur in
    practice (canonical / trainer npz-flat / nested), merge changes the
    targeted kernels, and unmatched adapter keys are a HARD error instead
    of a silent zero-delta merge (reference peft
    merge_and_unload round-trips, VLM2Vec/src/model.py:146-210)."""
    from clip_embeds.core.factory import flatten_params, unflatten_params
    from clip_embeds.models.lora import merge_lora, normalize_lora

    _, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(3))
    assert lora
    # force nonzero deltas (init sets b=0 so the delta would vanish)
    lora = {k: {"a": v["a"], "b": v["b"] + 0.1} for k, v in lora.items()}

    npz_flat = {k: np.asarray(v)
                for k, v in flatten_params(jax.device_get(lora)).items()}
    nested = unflatten_params(dict(npz_flat))
    assert normalize_lora(dict(npz_flat)).keys() == lora.keys()
    assert normalize_lora(nested).keys() == lora.keys()

    merged_c = merge_lora(base_params, lora, alpha=4.0)
    merged_f = merge_lora(base_params, dict(npz_flat), alpha=4.0)
    merged_n = merge_lora(base_params, nested, alpha=4.0)
    key = next(iter(lora))
    path = key.split("/")

    def leaf(tree):
        node = tree
        for p in path:
            node = node[p]
        return np.asarray(node)

    assert np.abs(leaf(merged_c) - leaf(base_params)).max() > 0  # != base
    np.testing.assert_allclose(leaf(merged_f), leaf(merged_c), rtol=1e-6)
    np.testing.assert_allclose(leaf(merged_n), leaf(merged_c), rtol=1e-6)

    with pytest.raises(ValueError, match="matched no param path"):
        merge_lora(base_params,
                   {"not/a/real/kernel": next(iter(lora.values()))})


def test_mmeb_embedding_cache_hit(tmp_path):
    """_cached_encode round-trips through the pickle cache: the second
    evaluate_subset call must NOT re-encode (reference eval.py:31+ skips
    encoding when the cache file exists)."""
    from clip_embeds.evals.mmeb import evaluate_subset

    rows = [
        {"qry_text": "q1", "qry_img_path": "", "tgt_text": ["a", "b"],
         "tgt_img_path": ["", ""]},
        {"qry_text": "q2", "qry_img_path": "", "tgt_text": ["c", "d"],
         "tgt_img_path": ["", ""]},
    ]
    calls = {"n": 0}

    def encode(pairs):
        calls["n"] += 1
        rng = np.random.default_rng(hash(tuple(p[0] for p in pairs)) % 2**31)
        return rng.standard_normal((len(pairs), 8)).astype(np.float32)

    r1 = evaluate_subset(rows, encode, encode, cache_dir=str(tmp_path),
                         subset="S")
    n_after_first = calls["n"]
    assert n_after_first == 2  # qry + tgt
    r2 = evaluate_subset(rows, encode, encode, cache_dir=str(tmp_path),
                         subset="S")
    assert calls["n"] == n_after_first  # pure cache hit
    assert r1 == r2
    # a different pair list must MISS (stale-cache guard)
    rows2 = rows + [{"qry_text": "q3", "qry_img_path": "",
                     "tgt_text": ["e", "f"], "tgt_img_path": ["", ""]}]
    evaluate_subset(rows2, encode, encode, cache_dir=str(tmp_path),
                    subset="S")
    assert calls["n"] > n_after_first


def test_vlm2vec_grad_cache_matches_plain():
    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    batch = _batch(n=4)
    step_plain = make_vlm2vec_train_step(model, base_params)
    step_gc = make_vlm2vec_train_step(model, base_params, grad_cache_chunks=2)
    s1 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    s2 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    _, m1 = step_plain(s1, batch)
    _, m2 = step_gc(s2, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)


def _mixed_batch(n=4, length=16):
    """Mixed MMEB-style batch: any row on either side may carry an image
    (exactly one sentinel per row; imageless rows park it in the pad area,
    outside the real-token mask — data/mmeb.py mixed_pair_batches layout)."""
    rng = np.random.default_rng(1)
    out = {}
    for prefix in ("qry", "tgt"):
        ids = np.zeros((n, length), np.int32)
        mask = np.zeros((n, length), bool)
        valid = rng.random(n) < 0.5
        valid[0], valid[1] = True, False  # deterministic coverage of both
        for i in range(n):
            L = int(rng.integers(6, length - 1))
            ids[i, :L] = rng.integers(1, 250, L)
            mask[i, :L] = True
            ids[i, 2 if valid[i] else length - 1] = -200
        out[f"{prefix}_ids"] = ids
        out[f"{prefix}_mask"] = mask
        out[f"{prefix}_pixels"] = rng.standard_normal(
            (n, 32, 32, 3)).astype(np.float32)
        out[f"{prefix}_image_valid"] = valid
    return out


def test_vlm2vec_mixed_training_step():
    from clip_embeds.train.vlm2vec import make_vlm2vec_mixed_train_step

    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    step = jax.jit(make_vlm2vec_mixed_train_step(model, base_params))
    state = TrainState.create(lora, adamw(1e-3, weight_decay=0.0))
    batch = _mixed_batch()
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_vlm2vec_mixed_grad_cache_matches_plain():
    from clip_embeds.train.vlm2vec import make_vlm2vec_mixed_train_step

    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    batch = _mixed_batch(n=4)
    step_plain = make_vlm2vec_mixed_train_step(model, base_params)
    step_gc = make_vlm2vec_mixed_train_step(model, base_params,
                                            grad_cache_chunks=2)
    s1 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    s2 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    _, m1 = step_plain(s1, batch)
    _, m2 = step_gc(s2, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-5)


def test_vlm2vec_mixed_full_finetune_step():
    """base_params=None: state.params IS the full tree (no adapters)."""
    from clip_embeds.train.vlm2vec import make_vlm2vec_mixed_train_step

    model, base_params = tiny_llava()
    step = jax.jit(make_vlm2vec_mixed_train_step(model, None))
    state = TrainState.create(base_params, adamw(1e-3, weight_decay=0.0))
    batch = _mixed_batch(n=2)
    state, m = step(state, batch)
    assert np.isfinite(float(m["loss"]))
    assert "language_model" in state.params  # full tree, not adapters


def test_train_vlm2vec_cli_synthetic(tmp_path):
    """End-to-end CLI smoke on the synthetic route: tiny random-init model,
    LoRA + grad-cache, adapter npz + merged score bundle written, and the
    merged bundle round-trips through build's loader."""
    from clip_embeds.cli.train_vlm2vec import main

    out = os.path.join(tmp_path, "run")
    rc = main([
        "--lora", "--lora_r", "2", "--max_steps", "2",
        "--per_device_train_batch_size", "2", "--grad_cache",
        "--gc_q_chunk_size", "1", "--logging_steps", "1",
        "--no_bf16", "--output_dir", out,
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "adapter-final.npz"))
    from clip_embeds.scores.build import load_score_bundle

    meta, params = load_score_bundle(os.path.join(out, "merged"))
    assert meta["family"] == "llava" and "language_model" in params


def test_train_vlm2vec_cli_mmeb_route(tmp_path):
    """CLI over an MMEB-style subset dir (mixed batches route)."""
    from clip_embeds.cli.train_vlm2vec import main

    img_path = os.path.join(tmp_path, "im.png")
    Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (40, 40, 3)).astype(np.uint8)
    ).save(img_path)
    rows = [
        {"qry": "<|image_1|> what is this?", "qry_image_path": "im.png",
         "pos_text": "a dog", "pos_image_path": ""},
        {"qry": "find the answer", "qry_image_path": "",
         "pos_text": "<|image_1|> the image", "pos_image_path": "im.png"},
    ]
    with open(os.path.join(tmp_path, "A.json"), "w") as fh:
        json.dump(rows, fh)
    out = os.path.join(tmp_path, "run")
    rc = main([
        "--lora", "--lora_r", "2", "--max_steps", "2",
        "--per_device_train_batch_size", "2", "--logging_steps", "1",
        "--dataset_name", str(tmp_path), "--subset_name", "A",
        "--image_dir", str(tmp_path), "--no_bf16", "--output_dir", out,
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "adapter-final.npz"))


def test_eval_mmeb_cli(tmp_path):
    """CLI smoke for the MMEB eval driver: tiny random model, fixture
    subset json, per-subset accuracy + cached embeddings + results.json;
    also exercises the trained-adapter merge route (train_vlm2vec output
    npz -> merge_lora before eval)."""
    from clip_embeds.cli.eval_mmeb import main as eval_main
    from clip_embeds.cli.train_vlm2vec import main as train_main

    img_path = os.path.join(tmp_path, "im.png")
    Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (40, 40, 3)).astype(np.uint8)
    ).save(img_path)
    rows = [
        {"qry_text": "what is shown?", "qry_img_path": "im.png",
         "tgt_text": ["a dog", "a cat", "a car"],
         "tgt_img_path": ["", "", ""]},
        {"qry_text": "describe it", "qry_img_path": "im.png",
         "tgt_text": ["something", "nothing"], "tgt_img_path": ["", ""]},
    ]
    with open(os.path.join(tmp_path, "Sub.json"), "w") as fh:
        json.dump(rows, fh)

    run = os.path.join(tmp_path, "run")
    assert train_main([
        "--lora", "--lora_r", "2", "--max_steps", "1",
        "--per_device_train_batch_size", "2", "--no_bf16",
        "--output_dir", run,
    ]) == 0
    cache = os.path.join(tmp_path, "embeds")
    rc = eval_main([
        "--checkpoint_path", os.path.join(run, "adapter-final.npz"),
        "--dataset_name", str(tmp_path), "--subset_name", "Sub",
        "--image_dir", str(tmp_path), "--encode_output_path", cache,
        "--per_device_train_batch_size", "2", "--no_bf16",
    ])
    assert rc == 0
    with open(os.path.join(cache, "results.json")) as fh:
        res = json.load(fh)
    assert res["subsets"]["Sub"]["num_pred"] == 2
    assert 0.0 <= res["average"] <= 1.0
    assert os.path.exists(os.path.join(cache, "Sub_qry"))  # embedding cache


def test_combined_pair_dataset(tmp_path):
    from clip_embeds.data.mmeb import CombinedPairDataset, pair_batches

    img_dir = tmp_path / "img"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    pretrain = []
    for i in range(6):
        name = f"{i}.jpg"
        Image.fromarray(
            rng.integers(0, 255, (36, 36, 3), dtype=np.uint8)
        ).save(img_dir / name)
        pretrain.append({
            "image": name,
            "conversations": [
                {"from": "human", "value": f"What is object {i}?\n<image>"},
                {"from": "gpt", "value": f"It is object number {i}."},
            ],
        })
    ann = tmp_path / "pretrain.json"
    ann.write_text(json.dumps(pretrain))

    ds = CombinedPairDataset(str(ann), None, str(img_dir))
    qry, img, tgt = ds.get(0)
    assert "<image>" in qry
    assert img.endswith("0.jpg")
    assert tgt.startswith("It is")

    batches = list(pair_batches(
        ds, _toy_tokenize, batch_size=2, bos_token_id=1, num_workers=2,
        image_size=32,
    ))
    assert len(batches) == 3
    b = batches[0]
    assert b["qry_pixels"].shape == (2, 32, 32, 3)
    assert (b["qry_ids"] == -200).sum() == 2  # one sentinel per query
    assert b["tgt_ids"].shape[0] == 2


def test_embedding_scorer():
    from clip_embeds.scores.embedding_scorer import EmbeddingScorer

    model, params = tiny_llava()
    scorer = EmbeddingScorer(
        model, params, _toy_tokenize, bos_token_id=1, batch_size=2,
    )
    rng = np.random.default_rng(0)
    imgs = [
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8))
        for _ in range(2)
    ]
    scores = scorer.score_batch([(imgs[0], ["opt a", "opt b"])])
    assert scores[0].shape == (2,)
    probs = scorer.pair_score(imgs, ["statement one", "statement two"])
    assert probs.shape == (2, 2)
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, rtol=1e-5)


def test_embed_mixed_matches_split_paths():
    """Mixed image/text batch == per-row single-path embeddings (the static
    replacement for the reference's image_mask row split)."""
    model, params = tiny_llava()
    rng = np.random.default_rng(1)
    n_image_tokens = model.cfg.n_image_tokens

    # row 0: image row "[1 2 <image> 3 4]"; row 1: text-only "[1 9 8]"
    L = 8
    ids = np.zeros((2, L), np.int32)
    mask = np.zeros((2, L), bool)
    ids[0, :5] = [1, 2, -200, 3, 4]
    mask[0, :5] = True
    ids[1, :3] = [1, 9, 8]
    ids[1, 3] = -200  # sentinel parked in the pad area
    mask[1, :3] = True
    pixels = np.zeros((2, 32, 32, 3), np.float32)
    pixels[0] = rng.standard_normal((32, 32, 3))
    image_valid = np.array([True, False])

    mixed = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(pixels),
        jnp.asarray(image_valid), jnp.asarray(mask), method="embed_mixed",
    ))

    # oracle row 0: plain image path on the single row
    single0 = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids[:1]), jnp.asarray(pixels[:1]),
        jnp.asarray(mask[:1]), method="embed_last_token",
    ))[0]
    # oracle row 1: text-only path on just the real ids
    single1 = np.asarray(model.apply(
        {"params": params}, jnp.asarray(ids[1:2, :3]), None,
        jnp.asarray(mask[1:2, :3]), method="embed_last_token",
    ))[0]
    np.testing.assert_allclose(mixed[0], single0, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(mixed[1], single1, rtol=2e-5, atol=2e-5)


def test_mmeb_train_dataset_and_mixed_batches(tmp_path):
    from clip_embeds.data.mmeb import MMEBTrainDataset, mixed_pair_batches

    # two subsets; one item has a query image, others are text-only
    img_path = os.path.join(tmp_path, "im.png")
    Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (40, 40, 3)).astype(np.uint8)
    ).save(img_path)
    subsets = {
        "A": [
            {"qry": "<|image_1|> what is this?", "qry_image_path": "im.png",
             "pos_text": "a dog", "pos_image_path": ""},
            {"qry": "find the answer", "qry_image_path": "",
             "pos_text": "<|image_1|> the image", "pos_image_path": "im.png"},
        ],
        "B": [
            {"qry": "text query", "qry_image_path": "",
             "pos_text": "text target", "pos_image_path": ""},
            {"qry": "capped out", "qry_image_path": "",
             "pos_text": "never seen", "pos_image_path": ""},
        ],
    }
    ds = MMEBTrainDataset(
        subsets, image_dir=str(tmp_path), num_sample_per_subset=1,
        model_backbone="llava_1.5",
    )
    assert len(ds) == 2  # per-subset cap applied
    qry, qimg, pos, pimg = ds.get(0)
    assert qry.startswith("<image>")  # marker rewritten for llava
    assert qimg and qimg.endswith("im.png") and pimg is None

    batches = list(mixed_pair_batches(
        ds, _toy_tokenize, batch_size=2, image_size=32, shuffle=False,
    ))
    assert len(batches) == 1
    b = batches[0]
    assert b["qry_image_valid"].tolist() == [True, False]
    assert b["tgt_image_valid"].tolist() == [False, False]
    # every row has exactly one sentinel (static splice invariant)
    assert ((b["qry_ids"] == -200).sum(axis=1) == 1).all()
    assert ((b["tgt_ids"] == -200).sum(axis=1) == 1).all()
    # imageless rows: sentinel excluded from the real-token mask
    srow = np.argmax(b["qry_ids"][1] == -200)
    assert not b["qry_mask"][1, srow]


def test_backbone_registry():
    """vlm_dict.py-equivalent name->family->native stack resolution."""
    import pytest as _pytest

    from clip_embeds.models.backbones import (
        HF_MODEL_TO_VLM_BACKBONE,
        get_backbone,
    )

    assert HF_MODEL_TO_VLM_BACKBONE["TIGER-Lab/VLM2Vec-Full"] == "phi3_v"
    for fam, cls_name in [
        ("llava_15", "Llava"), ("llava_next", "LlavaNext"),
        ("phi3_v", "Phi3V"), ("qwen2_vl", "Qwen2VL"),
        ("qwen2_5_vl", "Qwen25VL"),
    ]:
        b = get_backbone(fam)
        assert b.model_cls.__name__ == cls_name
        assert callable(b.converter) and callable(b.config_factory)
    # HF names resolve through the family table
    assert get_backbone(
        "llava-hf/llava-v1.6-mistral-7b-hf"
    ).model_cls.__name__ == "LlavaNext"
    with _pytest.raises(KeyError):
        get_backbone("not-a-backbone")


def test_vlm2vec_step_on_mesh_matches_single_device():
    """SURVEY §7 stage 6/7 multi-chip shape: frozen LLaVA trunk TP-sharded
    over 'model', batch over 'data', LoRA adapters replicated — the train
    step produces the same loss as the unsharded run (global-batch
    negatives through XLA-inserted collectives)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from clip_embeds.parallel.sharding_rules import shard_params

    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    batch = _batch(n=4)
    step = make_vlm2vec_train_step(model, base_params)
    s0 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    _, m_ref = step(s0, batch)

    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
    sharded_base = shard_params(mesh, base_params)
    step_sharded = make_vlm2vec_train_step(model, sharded_base)
    batch_sharded = {
        k: jax.device_put(v, NamedSharding(mesh, P("data")))
        for k, v in batch.items()
    }
    s1 = TrainState.create(
        jax.device_put(lora, NamedSharding(mesh, P())),
        adamw(0.0, weight_decay=0.0),
    )
    with mesh:
        _, m_mesh = jax.jit(step_sharded)(s1, batch_sharded)
    np.testing.assert_allclose(
        float(m_mesh["loss"]), float(m_ref["loss"]), rtol=2e-5
    )


def test_vlm2vec_step_with_fsdp_trunk_matches_single_device():
    """FSDP alternative to TP for the frozen trunk: every large base-param
    leaf sharded over 'data' (fsdp_param_specs); same loss as unsharded."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from clip_embeds.parallel.sharding_rules import fsdp_shard_params

    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    batch = _batch(n=8)
    step = make_vlm2vec_train_step(model, base_params)
    s0 = TrainState.create(lora, adamw(0.0, weight_decay=0.0))
    _, m_ref = step(s0, batch)

    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    sharded_base = fsdp_shard_params(mesh, base_params, min_size=64)
    step_sharded = make_vlm2vec_train_step(model, sharded_base)
    batch_sharded = {
        k: jax.device_put(v, NamedSharding(mesh, P("data")))
        for k, v in batch.items()
    }
    s1 = TrainState.create(
        jax.device_put(lora, NamedSharding(mesh, P())),
        adamw(0.0, weight_decay=0.0),
    )
    with mesh:
        _, m_mesh = jax.jit(step_sharded)(s1, batch_sharded)
    np.testing.assert_allclose(
        float(m_mesh["loss"]), float(m_ref["loss"]), rtol=2e-5
    )


def test_unmaterialized_lora_matches_materialize():
    """The unmaterialized side-path (quant.py _lora_delta via the 'lora'
    collection) computes exactly scale*(x@A)@B on top of the base matmul —
    the same function materialize() folds into the kernels, without the
    second full weight tree (the 7B single-chip enabler)."""
    from clip_embeds.models.lora import materialize, to_collection

    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(5))
    lora = {k: {"a": v["a"], "b": v["b"] + 0.05} for k, v in lora.items()}
    batch = _batch(n=2)

    mat_params = materialize(base_params, lora, alpha=16.0, train=False)
    ref = model.apply(
        {"params": mat_params}, batch["qry_ids"], batch["qry_pixels"],
        batch["qry_mask"], method="embed_last_token",
    )

    lmodel = Llava(model.cfg, attn_impl="reference", lora_rank=2,
                   lora_alpha=16.0)
    got = lmodel.apply(
        {"params": base_params, "lora": to_collection(lora)},
        batch["qry_ids"], batch["qry_pixels"], batch["qry_mask"],
        method="embed_last_token",
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)

    # zero-init collection (what model.init would build) == plain base
    zeros = jax.tree.map(jnp.zeros_like, to_collection(lora))
    base_out = model.apply(
        {"params": base_params}, batch["qry_ids"], batch["qry_pixels"],
        batch["qry_mask"], method="embed_last_token",
    )
    got0 = lmodel.apply(
        {"params": base_params, "lora": zeros},
        batch["qry_ids"], batch["qry_pixels"], batch["qry_mask"],
        method="embed_last_token",
    )
    np.testing.assert_allclose(np.asarray(got0), np.asarray(base_out),
                               rtol=1e-5, atol=1e-6)


def test_unmaterialized_train_step_matches_materialized():
    """One train step in unmaterialized mode produces the same loss and the
    same adapter update as the materialize() mode (they differentiate the
    same function of the adapters), including under grad-cache chunking."""
    model, base_params = tiny_llava()
    lora = init_lora(base_params, rank=2, rng=jax.random.PRNGKey(1))
    batch = _batch()
    lmodel = Llava(model.cfg, attn_impl="reference", lora_rank=2,
                   lora_alpha=16.0)

    for chunks in (0, 2):
        step_mat = jax.jit(make_vlm2vec_train_step(
            model, base_params, grad_cache_chunks=chunks))
        step_unm = jax.jit(make_vlm2vec_train_step(
            lmodel, base_params, grad_cache_chunks=chunks))
        s_mat = TrainState.create(lora, adamw(1e-3, weight_decay=0.0))
        s_unm = TrainState.create(lora, adamw(1e-3, weight_decay=0.0))
        s_mat, m_mat = step_mat(s_mat, batch)
        s_unm, m_unm = step_unm(s_unm, batch)
        np.testing.assert_allclose(float(m_unm["loss"]),
                                   float(m_mat["loss"]), rtol=1e-5)
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=5e-3, atol=1e-5),
            s_unm.params, s_mat.params)


def test_unmaterialized_lora_over_quant_base():
    """The QLoRA-shaped single-chip recipe: frozen W8A8 trunk + fp32
    adapters. init_lora targets the int8 'kernel_q' leaves (canonical
    '/kernel' keys), the train step runs and learns, and materialize() on
    the quantized base is a hard error pointing at this path."""
    from clip_embeds.models.lora import materialize
    from clip_embeds.models.quant import quantize_llava_trunk

    model, base_params = tiny_llava()
    qparams = quantize_llava_trunk(jax.device_get(base_params))
    lora = init_lora(qparams, rank=2, rng=jax.random.PRNGKey(2))
    assert lora and all(k.endswith("/kernel") for k in lora)
    assert set(lora) == set(init_lora(base_params, rank=2))

    qmodel = Llava(model.cfg, attn_impl="reference", quant_llm="dynamic",
                   lora_rank=2, lora_alpha=16.0)
    step = jax.jit(make_vlm2vec_train_step(qmodel, qparams))
    state = TrainState.create(lora, adamw(1e-3, weight_decay=0.0))
    batch = _batch()
    losses = []
    for _ in range(4):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]

    with pytest.raises(ValueError, match="matched no param path"):
        materialize(qparams, lora)


def test_train_vlm2vec_cli_quant_base(tmp_path):
    """--quant_base trains adapters over a frozen W8A8 trunk through the
    unmaterialized side-path end-to-end; the adapter npz is written and the
    merged-bundle export is (correctly) skipped for the int8 base."""
    from clip_embeds.cli.train_vlm2vec import main

    out = os.path.join(tmp_path, "run")
    rc = main([
        "--lora", "--lora_r", "2", "--quant_base", "--max_steps", "2",
        "--per_device_train_batch_size", "2", "--logging_steps", "1",
        "--no_bf16", "--output_dir", out,
    ])
    assert rc == 0
    adapter = dict(np.load(os.path.join(out, "adapter-final.npz")))
    assert adapter  # trained adapters saved
    assert not os.path.exists(os.path.join(out, "merged"))


def test_eval_mmeb_cli_quant_base_round_trip(tmp_path):
    """The int8 train -> eval loop closes: --quant_base training saves an
    adapter npz, and --quant_base eval serves it UNMATERIALIZED over the
    same frozen W8A8 base (merge_lora is impossible on int8 kernels).
    Also pins that the adapters actually change the embeddings vs the
    bare quantized base."""
    from clip_embeds.cli.eval_mmeb import main as eval_main
    from clip_embeds.cli.train_vlm2vec import main as train_main

    img_path = os.path.join(tmp_path, "im.png")
    Image.fromarray(
        np.random.default_rng(0).integers(0, 255, (40, 40, 3)).astype(np.uint8)
    ).save(img_path)
    rows = [
        {"qry_text": "what is shown?", "qry_img_path": "im.png",
         "tgt_text": ["a dog", "a cat"], "tgt_img_path": ["", ""]},
    ]
    with open(os.path.join(tmp_path, "Sub.json"), "w") as fh:
        json.dump(rows, fh)

    run = os.path.join(tmp_path, "run")
    assert train_main([
        "--lora", "--lora_r", "2", "--quant_base", "--max_steps", "1",
        "--per_device_train_batch_size", "2", "--no_bf16",
        "--output_dir", run,
    ]) == 0
    cache = os.path.join(tmp_path, "embeds")
    rc = eval_main([
        "--checkpoint_path", os.path.join(run, "adapter-final.npz"),
        "--quant_base", "--lora_r", "2",
        "--dataset_name", str(tmp_path), "--subset_name", "Sub",
        "--image_dir", str(tmp_path), "--encode_output_path", cache,
        "--per_device_train_batch_size", "2", "--no_bf16",
    ])
    assert rc == 0
    with open(os.path.join(cache, "results.json")) as fh:
        res = json.load(fh)
    assert res["subsets"]["Sub"]["num_pred"] == 1

    # adapters must move the embeddings vs the bare quantized base
    import pickle

    with open(os.path.join(cache, "Sub_qry"), "rb") as fh:
        with_adapter, _ = pickle.load(fh)
    cache2 = os.path.join(tmp_path, "embeds2")
    assert eval_main([
        "--quant_base", "--lora_r", "2",
        "--dataset_name", str(tmp_path), "--subset_name", "Sub",
        "--image_dir", str(tmp_path), "--encode_output_path", cache2,
        "--per_device_train_batch_size", "2", "--no_bf16",
    ]) == 0
    with open(os.path.join(cache2, "Sub_qry"), "rb") as fh:
        without, _ = pickle.load(fh)
    assert np.abs(np.asarray(with_adapter) - np.asarray(without)).max() > 0
