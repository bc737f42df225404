"""Reference train-loop features: patch dropout (transformer.py:48-88),
partial tower freezing (model.py lock_* / main.py:236-247), grad clip,
accum-freq aliasing, val evaluate() loop (train.py:270-377), checkpoint
policy (main.py:480-504), and mid-training zero-shot."""

import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from clip_embeds.core.factory import create_model
from clip_embeds.train.freeze import tower_freeze_labels


def test_patch_dropout_train_vs_eval():
    model, params = create_model("test-tiny", force_patch_dropout=0.5, seed=0)
    base, _ = create_model("test-tiny", seed=0)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))

    # eval path ignores dropout entirely -> identical to the no-dropout model
    a = model.apply({"params": params}, images, normalize=True,
                    method="encode_image")
    b = base.apply({"params": params}, images, normalize=True,
                   method="encode_image")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # train path drops patches: differs from eval, and differs across rngs
    t1 = model.apply({"params": params}, images, normalize=True,
                     method="encode_image", deterministic=False,
                     rngs={"patch_dropout": jax.random.PRNGKey(1)})
    t2 = model.apply({"params": params}, images, normalize=True,
                     method="encode_image", deterministic=False,
                     rngs={"patch_dropout": jax.random.PRNGKey(2)})
    assert not np.allclose(np.asarray(t1), np.asarray(a))
    assert not np.allclose(np.asarray(t1), np.asarray(t2))
    # same rng -> deterministic
    t1b = model.apply({"params": params}, images, normalize=True,
                      method="encode_image", deterministic=False,
                      rngs={"patch_dropout": jax.random.PRNGKey(1)})
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t1b))


def test_patch_dropout_static_token_count():
    model, params = create_model("test-tiny", force_patch_dropout=0.5, seed=0)
    n_patches = (model.cfg.vision.image_size // model.cfg.vision.patch_size) ** 2
    keep = max(1, int(n_patches * 0.5))
    rng = np.random.default_rng(1)
    images = jnp.asarray(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    _, tokens = model.apply(
        {"params": params}, images, method="encode_image",
        output_tokens=True, deterministic=False,
        rngs={"patch_dropout": jax.random.PRNGKey(0)},
    )
    assert tokens.shape[1] == keep  # CLS excluded from tokens, patches kept


def _label_set(labels, *path):
    node = labels
    for k in path:
        node = node[k]
    return set(jax.tree.leaves(node))


def test_freeze_labels_lock_image_groups():
    model, params = create_model("test-tiny", seed=0)
    L = model.cfg.vision.layers
    full = tower_freeze_labels(params, model.cfg, lock_image=True)
    assert _label_set(full, "visual") == {"freeze"}
    assert _label_set(full, "text") == {"train"}

    part = tower_freeze_labels(params, model.cfg, lock_image=True,
                               lock_image_unlocked_groups=2)
    # last group (ln_post/proj) + last resblock trainable
    assert _label_set(part, "visual", "ln_post") == {"train"}
    assert _label_set(part, "visual", "proj") == {"train"}
    assert _label_set(
        part, "visual", "transformer", f"resblocks_{L - 1}") == {"train"}
    assert _label_set(
        part, "visual", "transformer", "resblocks_0") == {"freeze"}
    assert _label_set(part, "visual", "patch_embed") == {"freeze"}


def test_freeze_labels_lock_text_layer_norm_flag():
    model, params = create_model("test-tiny", seed=0)
    L = model.cfg.text.layers
    soft = tower_freeze_labels(params, model.cfg, lock_text=True)
    # freeze_layer_norm unset -> LN params keep training inside the lock
    assert _label_set(
        soft, "text", "transformer", "resblocks_0", "ln_1") == {"train"}
    assert _label_set(
        soft, "text", "transformer", "resblocks_0", "attn") == {"freeze"}
    assert _label_set(soft, "text", "token_embedding") == {"freeze"}

    hard = tower_freeze_labels(params, model.cfg, lock_text=True,
                               lock_text_freeze_layer_norm=True,
                               lock_text_unlocked_layers=1)
    assert _label_set(
        hard, "text", "transformer", "resblocks_0", "ln_1") == {"freeze"}
    assert _label_set(
        hard, "text", "transformer", f"resblocks_{L - 1}") == {"train"}
    assert _label_set(hard, "text", "text_projection") == {"train"}
    assert _label_set(hard, "visual") == {"train"}


def _write_csv_corpus(tmp_path, n=16):
    rng = np.random.default_rng(0)
    rows = ["filepath\ttitle"]
    for i in range(n):
        p = tmp_path / f"img{i}.jpg"
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(p, format="JPEG")
        rows.append(f"{p}\tcaption number {i}")
    path = tmp_path / "data.tsv"
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.mark.slow
def test_train_cli_full_feature_pass(tmp_path, monkeypatch):
    """One CLI run exercising lock-text, patch dropout, grad clip,
    accum-freq, val evaluate, zero-shot frequency and checkpoint policy."""
    from clip_embeds.cli import train as train_cli
    from clip_embeds.evals import zero_shot as zs

    csv_path = _write_csv_corpus(tmp_path)

    # tiny fake ImageNet val: 2 classes x 2 images, tiny metadata
    rng = np.random.default_rng(1)
    inet = tmp_path / "inet"
    for ci in range(2):
        d = inet / f"n{ci:08d}"
        d.mkdir(parents=True)
        for j in range(2):
            Image.fromarray(
                rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
            ).save(d / f"{j}.jpg", format="JPEG")
    monkeypatch.setattr(zs, "load_imagenet_metadata", lambda: {
        "classnames": ["cat", "dog"],
        "templates": ["a photo of a {c}."],
    })

    ckpt_dir = tmp_path / "ckpts"
    logs = tmp_path / "logs"
    state = train_cli.main([
        "--model", "test-tiny", "--dataset-type", "csv",
        "--train-data", csv_path, "--batch-size", "8", "--epochs", "2",
        "--precision", "fp32", "--log-every", "1",
        "--force-patch-dropout", "0.5", "--grad-clip-norm", "1.0",
        "--lock-text", "--lock-text-freeze-layer-norm",
        "--val-data", csv_path, "--val-frequency", "1",
        "--imagenet-val", str(inet), "--zeroshot-frequency", "2",
        "--checkpoint-dir", str(ckpt_dir), "--save-frequency", "1",
        "--delete-previous-checkpoint",
        "--report-to", "jsonl", "--logs", str(logs), "--name", "t",
    ])
    assert int(state.step) == 4

    # delete-previous-checkpoint: only the newest epoch dir remains
    kept = sorted(p for p in os.listdir(ckpt_dir) if p.startswith("epoch_"))
    assert kept == ["epoch_2"]

    # locked text subtree stayed frozen (embeddings exactly unchanged)
    _, params0 = create_model("test-tiny", seed=0)
    final = jax.device_get(state.params)
    np.testing.assert_array_equal(
        final["text"]["token_embedding"]["embedding"],
        params0["text"]["token_embedding"]["embedding"],
    )
    # but the visual tower trained
    assert not np.allclose(
        final["visual"]["proj"], params0["visual"]["proj"])

    # jsonl metrics written, incl. val + zero-shot lines
    jsonl = (logs / "t" / "results.jsonl").read_text().splitlines()
    assert any("clip_val_loss" in ln for ln in jsonl)
    assert any("imagenet-zeroshot-val-top1" in ln for ln in jsonl)


@pytest.mark.slow
def test_train_cli_accum_freq_maps_to_grad_cache(tmp_path):
    from clip_embeds.cli import train as train_cli

    csv_path = _write_csv_corpus(tmp_path)
    state = train_cli.main([
        "--model", "test-tiny", "--dataset-type", "csv",
        "--train-data", csv_path, "--batch-size", "8", "--epochs", "1",
        "--precision", "fp32", "--accum-freq", "2", "--log-every", "1",
    ])
    assert int(state.step) == 2


@pytest.mark.slow
def test_train_cli_const_cooldown_and_remote_sync(tmp_path):
    """--lr-scheduler const-cooldown reaches the cooldown schedule (was
    silently falling back to plain const), and --remote-sync mirrors the
    checkpoint dir locally."""
    from clip_embeds.cli import train as train_cli

    csv_path = _write_csv_corpus(tmp_path)
    ckpt_dir = tmp_path / "ckpts"
    mirror = tmp_path / "mirror"
    state = train_cli.main([
        "--model", "test-tiny", "--dataset-type", "csv",
        "--train-data", csv_path, "--batch-size", "8", "--epochs", "2",
        "--precision", "fp32", "--log-every", "1",
        "--lr-scheduler", "const-cooldown", "--epochs-cooldown", "1",
        "--lr", "1e-3", "--lr-cooldown-end", "0.0",
        "--checkpoint-dir", str(ckpt_dir),
        "--remote-sync", str(mirror), "--remote-sync-frequency", "1",
    ])
    assert int(state.step) == 4
    # final_sync on stop() mirrors the completed checkpoints (orbax tmp
    # dirs are skipped; a mid-write pass may have copied an epoch that was
    # later pruned, so assert superset-of-completed)
    completed = {d for d in os.listdir(ckpt_dir) if ".tmp" not in d}
    assert completed <= set(os.listdir(mirror))
    assert not any(".orbax-checkpoint-tmp" in d for d in os.listdir(mirror))


def test_coca_train_step_decreases_loss():
    from clip_embeds.core.config import TextConfig, VisionConfig
    from clip_embeds.models.coca import CoCa, CoCaConfig, MultimodalConfig
    from clip_embeds.train.optim import adamw
    from clip_embeds.train.steps import TrainState, make_coca_train_step

    cfg = CoCaConfig(
        embed_dim=32,
        vision=VisionConfig(image_size=32, patch_size=8, width=32, layers=2,
                            head_width=16),
        text=TextConfig(context_length=15, vocab_size=128, width=32, heads=2,
                        layers=2),
        multimodal=MultimodalConfig(context_length=15, width=32, heads=2,
                                    layers=2),
        attn_pooler_queries=8, attn_pooler_heads=2,
    )
    model = CoCa(cfg)
    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.standard_normal((4, 32, 32, 3)).astype(np.float32))
    texts = jnp.asarray(rng.integers(1, 128, (4, 15)).astype(np.int32))
    params = model.init(jax.random.PRNGKey(0), images, texts)["params"]

    step = jax.jit(make_coca_train_step(model, 2.0, 1.0))
    state = TrainState.create(params, adamw(1e-3))
    batch = {"images": images, "texts": texts}
    losses = []
    for _ in range(5):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert float(metrics["caption_loss"]) > 0
    assert float(metrics["contrastive_loss"]) > 0


@pytest.mark.slow
def test_factory_builds_coca_by_name():
    model, params = create_model("coca_ViT-B-32")
    assert type(model).__name__ == "CoCa"
    assert model.cfg.embed_dim == 512
    assert model.cfg.multimodal.layers == 12
    assert "text_decoder" in params


def test_remat_attn_policy_grads_match_full_remat():
    from clip_embeds.models.clip import CLIP

    base, params = create_model("test-tiny", seed=0)
    rng = np.random.default_rng(0)
    batch_img = jnp.asarray(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    batch_txt = jnp.asarray(rng.integers(1, 200, (2, 77)).astype(np.int32))

    def loss_fn(model):
        def f(p):
            out = model.apply({"params": p}, batch_img, batch_txt)
            return (out["image_features"] * out["text_features"]).sum()
        return jax.grad(f)(params)

    g_full = loss_fn(CLIP(base.cfg, remat=True))
    g_attn = loss_fn(CLIP(base.cfg, remat="attn"))
    for a, b in zip(jax.tree.leaves(g_full), jax.tree.leaves(g_attn)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_train_cli_fsdp(tmp_path):
    """--fsdp trains with params sharded over the 8-device data axis."""
    from clip_embeds.cli import train as train_cli

    csv_path = _write_csv_corpus(tmp_path)
    state = train_cli.main([
        "--model", "test-tiny", "--dataset-type", "csv",
        "--train-data", csv_path, "--batch-size", "8", "--epochs", "1",
        "--precision", "fp32", "--log-every", "1", "--fsdp",
    ])
    assert int(state.step) == 2
    leaf = state.params["visual"]["transformer"]["resblocks_0"]["mlp"][
        "c_fc"]["kernel"]
    assert not leaf.sharding.is_fully_replicated


@pytest.mark.slow
def test_train_cli_async_checkpoints(tmp_path):
    from clip_embeds.cli import train as train_cli
    from clip_embeds.core import checkpoint as ckpt

    csv_path = _write_csv_corpus(tmp_path)
    ckpt_dir = tmp_path / "ck"
    state = train_cli.main([
        "--model", "test-tiny", "--dataset-type", "csv",
        "--train-data", csv_path, "--batch-size", "8", "--epochs", "2",
        "--precision", "fp32", "--log-every", "1",
        "--checkpoint-dir", str(ckpt_dir), "--async-checkpoints",
        "--delete-previous-checkpoint",
    ])
    assert int(state.step) == 4
    # all async writes committed, prune kept only the newest
    kept = sorted(p for p in os.listdir(ckpt_dir) if p.startswith("epoch_"))
    assert kept == ["epoch_2"]
    restored = ckpt.resume(str(ckpt_dir), {
        "params": jax.device_get(state.params), "step": np.asarray(0)})
    assert int(restored["step"]) == 2


@pytest.mark.slow
def test_train_pacl_cli_both_objectives(tmp_path):
    """PACL and SPARC head training end-to-end (frozen tiny tower, synthetic
    pairs), saved head loads back into the eval scorer's head module."""
    from clip_embeds.cli.train_pacl import main as pacl_main
    from clip_embeds.core.factory import load_params

    for objective in ("pacl", "sparc"):
        out = tmp_path / f"{objective}_head.npz"
        state = pacl_main([
            "--objective", objective, "--model", "test-tiny",
            "--synthetic", "--train-num-samples", "16",
            "--batch-size", "8", "--epochs", "1", "--proj-dim", "32",
            "--rope", "before" if objective == "pacl" else "none",
            "--log-every", "1", "--output", str(out),
        ])
        assert int(state.step) == 2
        restored = load_params(str(out))
        assert "visual_projection" in restored
        for a, b in zip(jax.tree.leaves(restored),
                        jax.tree.leaves(jax.device_get(state.params))):
            np.testing.assert_array_equal(a, b)
