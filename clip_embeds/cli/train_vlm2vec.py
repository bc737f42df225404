"""VLM2Vec embedding-training driver.

JAX equivalent of the reference entry point ``VLM2Vec/train.py``
(train.py:29-103 + scripts/llava_1.5/run_train.sh:3-15): turn a VLM
(LLaVA-1.5) into an embedding model with LoRA + in-batch contrastive loss
(T=0.02) + optional GradCache. Arguments are the reference's own dataclasses
(train/arguments.py mirrors VLM2Vec/src/arguments.py field-for-field), parsed
with the HfArgumentParser-equivalent ``parse_dataclasses`` — the reference's
run scripts translate flag-for-flag, with torchrun/DDP replaced by a
(data x model) mesh.

Data routes (all zero-egress: local files instead of HF downloads):
  --dataset_name <dir> --subset_name A B ...   MMEB-style training: each
      subset is <dir>/<name>.json[l] with rows {qry, qry_image_path,
      pos_text, pos_image_path}; batches are MIXED (any row on either side
      may carry an image) via the static-splice collator
      (data/mmeb.py mixed_pair_batches -> Llava.embed_mixed).
  --dataset_name <pretrain.json> [--subset_name <instruct.json>]   the
      Combined 558K+665K route (query = question+image, target = answer;
      VLM2Vec/src/dataset.py:75-146) via pair_batches.
  --dataset_name omitted   synthetic random batches (smoke runs / CI).

Checkpoints: ``--checkpoint_path`` loads a converted score bundle
(scores/build.py layout: config.json + params.npz [+ tokenizer/]); omitted,
a tiny random-init LLaVA runs the recipe end-to-end for smoke tests. The
trained adapter tree is saved as npz every --save_steps, and at the end the
merged model (models/lora.merge_lora == peft merge_and_unload,
VLM2Vec/src/model.py:194-203) is exported as a score bundle ready for
``build_score_model`` / the MMEB eval drivers.

Usage:
  python -m clip_embeds.cli.train_vlm2vec \
      --checkpoint_path /bundles/llava-v1.5-7b --lora --lora_r 16 \
      --dataset_name /data/mmeb --subset_name ImageNet_1K OK-VQA \
      --image_dir /data/mmeb/images --num_sample_per_subset 50000 \
      --per_device_train_batch_size 64 --grad_cache --gc_q_chunk_size 2 \
      --learning_rate 2e-5 --max_steps 1000 --output_dir /ckpt/vlm2vec
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np


def _load_subset_rows(path: str):
    """Rows from a .json (list) or .jsonl file."""
    if path.endswith(".jsonl"):
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]
    with open(path) as fh:
        return json.load(fh)


def _toy_tokenize(text: str):
    """Deterministic fallback tokenizer for synthetic/smoke runs (no
    bundle tokenizer): crc32-hashed whitespace tokens over a small vocab.
    crc32, not hash(): hash() is PYTHONHASHSEED-randomized, so cached
    embeddings/adapters would be inconsistent across processes."""
    import zlib

    return [1] + [2 + (zlib.crc32(w.encode()) % 97) for w in text.split()]


def _synthetic_mixed_batches(
    batch_size: int, image_size: int, seed: int,
) -> Iterator[Dict[str, np.ndarray]]:
    """Random mixed batches matching data/mmeb.py mixed_pair_batches keys."""
    from ..models.llava import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(seed)
    ln = 64
    while True:
        out = {}
        for prefix in ("qry", "tgt"):
            ids = rng.integers(2, 90, (batch_size, ln)).astype(np.int32)
            mask = np.zeros((batch_size, ln), bool)
            valid = rng.random(batch_size) < (0.8 if prefix == "qry" else 0.3)
            for i in range(batch_size):
                n_real = int(rng.integers(8, ln - 1))
                ids[i, n_real:] = 0
                ids[i, n_real - 1 if valid[i] else ln - 1] = IMAGE_TOKEN_INDEX
                mask[i, : n_real - (1 if valid[i] else 0)] = True
                if valid[i]:
                    mask[i, n_real - 1] = True  # sentinel is a real position
            out[f"{prefix}_ids"] = ids
            out[f"{prefix}_mask"] = mask
            out[f"{prefix}_pixels"] = rng.standard_normal(
                (batch_size, image_size, image_size, 3)
            ).astype(np.float32)
            out[f"{prefix}_image_valid"] = valid
        yield out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("train_vlm2vec")

    from ..train.arguments import (
        DataArguments,
        ModelArguments,
        TrainingArguments,
        parse_dataclasses,
    )

    model_args, data_args, training_args = parse_dataclasses(
        [ModelArguments, DataArguments, TrainingArguments], argv
    )

    import jax
    import jax.numpy as jnp

    from ..core.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    from ..models.llava import Llava, llava_tiny_config
    from ..models.lora import init_lora, merge_lora
    from ..scores.build import (
        config_from_dict,
        load_score_bundle,
        save_score_bundle,
    )
    from ..scores.vqa_score import hf_tokenizer_adapter
    from ..train.optim import adamw
    from ..train.schedules import const_lr, cosine_lr, linear_lr
    from ..train.steps import TrainState
    from ..train.vlm2vec import (
        make_vlm2vec_mixed_train_step,
        make_vlm2vec_train_step,
    )

    from ..models.llava import LlavaConfig

    dtype = jnp.bfloat16 if training_args.bf16 else jnp.float32

    # -- model + base params --------------------------------------------------
    tokenize, bos_id, pad_id = _toy_tokenize, 1, 0
    ckpt = model_args.checkpoint_path
    if ckpt:
        meta, base_params = load_score_bundle(ckpt)
        cfg = config_from_dict(LlavaConfig, meta.get("model", {}))
        tok_dir = os.path.join(ckpt, "tokenizer")
        if os.path.isdir(tok_dir):
            from transformers import AutoTokenizer

            tokenize, bos_id, pad_id = hf_tokenizer_adapter(
                AutoTokenizer.from_pretrained(tok_dir)
            )
        else:
            log.warning(
                "bundle %s has NO tokenizer/ subdir — falling back to the "
                "toy hashed tokenizer; real-checkpoint training with it "
                "produces garbage", ckpt)
    else:
        log.info("no --checkpoint_path: tiny random-init LLaVA (smoke run)")
        cfg = llava_tiny_config()
    model = Llava(cfg, dtype=dtype)
    if not ckpt:
        base_params = model.init(
            jax.random.PRNGKey(training_args.seed),
            np.zeros((1, 8), np.int32),
            np.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3),
                     np.float32),
        )["params"]

    if model_args.quant_base:
        # QLoRA-shaped single-chip recipe: W8A8 trunk + fp32 adapters
        # through the unmaterialized side-path (train/vlm2vec.py docstring).
        if not model_args.lora:
            raise ValueError("--quant_base requires --lora (the int8 trunk "
                             "is frozen; only adapters train)")
        from ..models.quant import quantize_llava_trunk

        base_params = quantize_llava_trunk(jax.device_get(base_params))
        model = Llava(cfg, dtype=dtype, quant_llm="dynamic", remat=True,
                      lora_rank=model_args.lora_r,
                      lora_alpha=float(model_args.lora_alpha))
        log.info("--quant_base: W8A8 trunk + unmaterialized LoRA r=%d",
                 model_args.lora_r)

    # -- mesh sizing (before data: the GLOBAL batch is per_device * n_dp,
    # matching the reference's torchrun semantics where the in-batch
    # negatives pool is bs * world_size) -----------------------------------
    n_mp = max(training_args.model_parallel, 1)
    n_dp = training_args.data_parallel
    if n_dp == -1:
        n_dp = len(jax.devices()) // n_mp
    n_dp = max(n_dp, 1)
    n_mesh_devices = n_dp * n_mp if n_dp * n_mp > 1 else 1

    # -- data ------------------------------------------------------------------
    bs = training_args.per_device_train_batch_size * n_dp
    if n_dp > 1:
        log.info("global batch %d = %d per device x %d data-parallel",
                 bs, training_args.per_device_train_batch_size, n_dp)
    image_size = cfg.vision.image_size
    name = data_args.dataset_name
    if name is None:
        batches = _synthetic_mixed_batches(bs, image_size, training_args.seed)
    elif os.path.isdir(name):
        from ..data.mmeb import MMEBTrainDataset, mixed_pair_batches

        subsets = {}
        for sub in data_args.subset_name or []:
            for ext in (".json", ".jsonl"):
                p = os.path.join(name, sub + ext)
                if os.path.exists(p):
                    subsets[sub] = _load_subset_rows(p)
                    break
            else:
                raise FileNotFoundError(f"no {sub}.json[l] under {name}")
        ds = MMEBTrainDataset(
            subsets,
            image_dir=data_args.image_dir or name,
            num_sample_per_subset=data_args.num_sample_per_subset,
            model_backbone=model_args.model_backbone,
        )
        log.info("MMEB train set: %d rows over %d subsets",
                 len(ds), len(subsets))

        def batches_epochs():
            epoch = 0
            while True:
                yield from mixed_pair_batches(
                    ds, tokenize, bs, bos_token_id=bos_id,
                    pad_token_id=pad_id, max_len=data_args.max_len,
                    image_size=image_size, seed=training_args.seed + epoch,
                )
                epoch += 1

        batches = batches_epochs()
    else:
        from ..data.mmeb import CombinedPairDataset, pair_batches

        instruct = (data_args.subset_name or [None])[0]
        ds = CombinedPairDataset(
            name, instruct, data_args.image_dir or "",
            seed=training_args.seed,
        )
        log.info("Combined pair set: %d samples", len(ds))

        def batches_epochs():
            epoch = 0
            while True:
                yield from pair_batches(
                    ds, tokenize, bs, bos_token_id=bos_id,
                    pad_token_id=pad_id, max_len=data_args.max_len,
                    image_size=image_size, seed=training_args.seed + epoch,
                )
                epoch += 1

        batches = batches_epochs()

    mixed = name is None or os.path.isdir(name or "")

    # -- trainable tree + optimizer -------------------------------------------
    if model_args.lora:
        trainable = init_lora(
            base_params, rank=model_args.lora_r,
            rng=jax.random.PRNGKey(training_args.seed + 1),
            targets=model_args.lora_targets,
        )
        log.info("LoRA adapters on %d kernels (r=%d, alpha=%d)",
                 len(trainable), model_args.lora_r, model_args.lora_alpha)
        step_base = base_params
    else:
        trainable, step_base = base_params, None
        if training_args.image_encoder_freeze and not mixed:
            log.info("--image_encoder_freeze: vision grads masked")

    total = training_args.max_steps
    sched = {
        "linear": lambda: linear_lr(
            training_args.learning_rate, training_args.warmup_steps, total),
        "cosine": lambda: cosine_lr(
            training_args.learning_rate, training_args.warmup_steps, total),
        "const": lambda: const_lr(
            training_args.learning_rate, training_args.warmup_steps),
    }[training_args.lr_scheduler_type]()
    # HF TrainingArguments default: weight_decay 0 (run_train.sh sets none)
    tx = adamw(sched, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    if not model_args.lora and training_args.image_encoder_freeze:
        import optax

        def no_vision(params):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: not any(
                    getattr(k, "key", None) == "vision_tower" for k in path
                ),
                params,
            )

        tx = optax.masked(tx, no_vision)
    state = TrainState.create(trainable, tx)

    chunks = 0
    if training_args.grad_cache:
        chunk_size = max(training_args.gc_q_chunk_size, 1)
        if bs % chunk_size:
            raise ValueError(
                f"batch size {bs} not divisible by gc_q_chunk_size "
                f"{chunk_size}")
        chunks = bs // chunk_size

    if not mixed and step_base is None:
        raise ValueError(
            "the Combined pair route trains LoRA adapters (pass --lora)")

    # -- mesh ------------------------------------------------------------------
    # batch sharded over 'data', params replicated (the DDP analogue; the
    # global contrastive matmul IS the negatives gather under pjit)
    mesh = None
    if n_dp * n_mp > 1:
        from ..parallel.mesh import create_mesh, replicated_sharding

        mesh = create_mesh(n_dp, n_mp,
                           devices=jax.devices()[: n_dp * n_mp])
        log.info("mesh: %s", mesh)
        rep = replicated_sharding(mesh)
        state = jax.device_put(state, rep)
        if step_base is not None:
            # the frozen base rides outside the train state; co-locate it
            step_base = jax.device_put(step_base, rep)

    make = (make_vlm2vec_mixed_train_step if mixed
            else make_vlm2vec_train_step)
    step = jax.jit(make(
        model, step_base, lora_alpha=float(model_args.lora_alpha),
        temperature=model_args.temperature, grad_cache_chunks=chunks,
    ))

    out_dir = training_args.output_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def save_trainable(tag: str):
        if not out_dir:
            return
        from ..core.factory import flatten_params

        path = os.path.join(out_dir, f"adapter-{tag}.npz"
                            if model_args.lora else f"params-{tag}.npz")
        np.savez(path, **flatten_params(jax.device_get(state.params)))
        log.info("saved %s", path)

    # -- loop ------------------------------------------------------------------
    log.info("training %d steps (bs %d%s%s)", total, bs,
             f", grad-cache chunks {chunks}" if chunks else "",
             ", mixed batches" if mixed else ", image-query pairs")
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        if i >= total:
            break
        batch = {k: (jnp.asarray(v) if not isinstance(v, jnp.ndarray) else v)
                 for k, v in batch.items()}
        if mesh is not None:
            from ..parallel.mesh import shard_batch

            batch = shard_batch(mesh, batch)
        state, metrics = step(state, batch)
        if (i + 1) % training_args.logging_steps == 0:
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            log.info("step %d/%d loss %.4f (%.1f samples/s/chip)",
                     i + 1, total, loss,
                     bs * (i + 1) / dt / n_mesh_devices)
        if (i + 1) % training_args.save_steps == 0 and i + 1 < total:
            save_trainable(f"{i + 1:06d}")

    save_trainable("final")
    if out_dir and model_args.lora:
        if model_args.quant_base:
            # int8 kernels cannot absorb fp deltas — serve the adapter
            # beside the int8 bundle through the unmaterialized path
            # (Llava(lora_rank=r) + {'params': base, 'lora':
            # to_collection(adapter)}); adapter-final.npz above is the
            # artifact.
            log.info("--quant_base: skipping merged-bundle export (int8 "
                     "base; serve adapter-final.npz unmaterialized)")
        else:
            merged = merge_lora(base_params, jax.device_get(state.params),
                                alpha=float(model_args.lora_alpha))
            save_score_bundle(
                os.path.join(out_dir, "merged"), "llava", cfg, merged,
                conversation="chat",
            )
            log.info("saved merged score bundle -> %s",
                     os.path.join(out_dir, "merged"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
