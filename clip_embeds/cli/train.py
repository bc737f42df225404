"""Training CLI: the JAX equivalent of `torchrun -m training.main`.

Reference: open_clip/src/open_clip_train/main.py + train.py and the launch
recipe in open_clip/src/train-clip.sh:7-43 (ViT-L-14-336, --lock-image,
--usehardtext, --augfiles leftright.json, datamix data). One process drives the
whole mesh; there is no per-rank bootstrap.

Example:
  python -m clip_embeds.cli.train --model ViT-L-14-336 \
      --dataset-type synthetic --train-num-samples 64 --batch-size 16 --epochs 1
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Iterator

import numpy as np


class ParseKwargs(argparse.Action):
    """key=value list -> dict with literal-eval values (reference
    params.py:14-22 ParseKwargs, used by --aug-cfg)."""

    def __call__(self, parser, namespace, values, option_string=None):
        import ast

        kw = {}
        for value in values:
            key, value = value.split("=", 1)
            try:
                kw[key] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                kw[key] = str(value)
        setattr(namespace, self.dest, kw)


def build_train_transform(args, model_cfg):
    """RandomResizedCrop(+aug_cfg) train transform for the model's geometry
    (reference main.py:223-231 create_model_and_transforms(..., aug_cfg) ->
    preprocess_train; transform.py:276-345)."""
    # getattr: programmatic callers build bare Namespaces without the flags
    if getattr(args, "no_train_aug", False):
        return None
    from ..image.transform import image_transform

    return image_transform(
        model_cfg.vision.image_size, is_train=True,
        aug_cfg=getattr(args, "aug_cfg", None) or None,
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds trainer")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--batch-size", type=int, default=64, help="global batch")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=5e-6)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.98)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--warmup", type=int, default=140)
    p.add_argument("--lr-scheduler", default="cosine",
                   choices=["cosine", "const", "const-cooldown"])
    p.add_argument("--lock-image", action="store_true",
                   help="LiT: freeze the vision tower (main.py:271-275)")
    p.add_argument("--usehardtext", action="store_true")
    p.add_argument("--augfiles", nargs="*", default=None)
    p.add_argument("--aug-cfg", nargs="*", default={}, action=ParseKwargs,
                   help="train-augmentation key=value pairs (reference "
                        "params.py:264 --aug-cfg; transform.py:63-72 "
                        "AugmentationCfg), e.g. scale='(0.8,1.0)' "
                        "color_jitter='(0.4,0.4,0.4,0.1)' "
                        "color_jitter_prob=0.8 gray_scale_prob=0.2")
    p.add_argument("--no-train-aug", action="store_true",
                   help="train on the deterministic eval transform instead "
                        "of RandomResizedCrop (not what the reference does; "
                        "for ablation)")
    p.add_argument("--siglip", action="store_true")
    p.add_argument("--distill-model", default=None,
                   help="teacher arch to distill from (params.py:461-464)")
    p.add_argument("--distill-pretrained", default=None,
                   help="teacher weights tag/path (params.py:466-469)")
    p.add_argument("--grad-cache-chunks", type=int, default=0)
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--grad-checkpointing-policy", default="full",
                   choices=["full", "dots", "attn"],
                   help="'dots' keeps matmul outputs resident "
                        "(jax dots_with_no_batch_dims_saveable)")
    p.add_argument("--dataset-type", default="synthetic",
                   choices=["synthetic", "datamix", "csv", "webdataset",
                            "auto"])
    p.add_argument("--train-data", nargs="*", default=None,
                   help="datamix annotation jsons / csv-tsv file / wds "
                        "tar url(s) with {000..127} brace expansion")
    p.add_argument("--csv-img-key", default="filepath")
    p.add_argument("--csv-caption-key", default="title")
    p.add_argument("--csv-separator", default="\t")
    p.add_argument("--dataset-resampled", action="store_true",
                   help="wds: sample shards with replacement")
    p.add_argument("--train-data-upsampling-factors", default=None,
                   help="wds: '::'-separated per-url weights")
    p.add_argument("--wds-shuffle-buffer", type=int, default=5000,
                   help="wds sample shuffle buffer (reference detshuffle2 "
                        "_SAMPLE_SHUFFLE_SIZE=5000)")
    p.add_argument("--val-data", default=None,
                   help="csv/tsv or wds tar of held-out pairs")
    p.add_argument("--val-frequency", type=int, default=1)
    p.add_argument("--val-num-samples", type=int, default=512)
    p.add_argument("--imagenet-val", default=None,
                   help="ImageFolder-style ImageNet val root for zero-shot")
    p.add_argument("--zeroshot-frequency", type=int, default=2)
    p.add_argument("--accum-freq", type=int, default=1,
                   help="gradient accumulation; maps to the exact-gradient "
                        "GradCache engine (open_clip train.py:113-162 "
                        "cached-feature replay)")
    p.add_argument("--grad-clip-norm", type=float, default=None)
    p.add_argument("--force-quick-gelu", action="store_true")
    p.add_argument("--force-patch-dropout", type=float, default=None)
    p.add_argument("--lock-text", action="store_true")
    p.add_argument("--lock-text-unlocked-layers", type=int, default=0)
    p.add_argument("--lock-text-freeze-layer-norm", action="store_true")
    p.add_argument("--lock-image-unlocked-groups", type=int, default=0)
    p.add_argument("--save-frequency", type=int, default=1)
    p.add_argument("--async-checkpoints", action="store_true",
                   help="overlap checkpoint serialization with the next "
                        "epoch (orbax AsyncCheckpointer)")
    p.add_argument("--save-most-recent", action="store_true")
    p.add_argument("--delete-previous-checkpoint", action="store_true")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-shard params over the data axis "
                        "(parallel/sharding_rules.py fsdp_param_specs; "
                        "ZeRO-3-style, exact same math)")
    p.add_argument("--coca-caption-loss-weight", type=float, default=2.0)
    p.add_argument("--coca-contrastive-loss-weight", type=float, default=1.0)
    p.add_argument("--epochs-cooldown", type=int, default=None,
                   help="const-cooldown: cooldown over the last N epochs")
    p.add_argument("--lr-cooldown-end", type=float, default=0.0)
    p.add_argument("--lr-cooldown-power", type=float, default=1.0)
    p.add_argument("--remote-sync", default=None,
                   help="remote dir to sync checkpoints/logs to")
    p.add_argument("--remote-sync-frequency", type=int, default=300)
    p.add_argument("--remote-sync-protocol", default="s3",
                   choices=["s3", "fsspec"])
    p.add_argument("--report-to", default="",
                   help="comma list: jsonl,tensorboard,wandb")
    p.add_argument("--logs", default=None,
                   help="log root; metrics land in <logs>/<name>/")
    p.add_argument("--name", default=None)
    p.add_argument("--lcs-root", default=None)
    p.add_argument("--datamix-root", default=None)
    p.add_argument("--train-num-samples", type=int, default=64)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", default=None, help="'latest' or a path")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def build_data(args, model_cfg, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    dataset_type = args.dataset_type
    if dataset_type == "auto":
        # reference get_dataset_fn auto rule (data.py:675-683)
        ext = args.train_data[0].split(".")[-1]
        if ext in ("csv", "tsv"):
            dataset_type = "csv"
        elif ext == "tar":
            dataset_type = "webdataset"
        else:
            raise ValueError(
                f"cannot infer dataset type from extension {ext!r}")
    if dataset_type == "csv":
        from ..data.csv_dataset import CsvPairDataset, csv_batches
        from ..text.tokenizer import get_tokenizer

        ds = CsvPairDataset(
            args.train_data[0], img_key=args.csv_img_key,
            caption_key=args.csv_caption_key, sep=args.csv_separator,
        )
        steps = len(ds) // args.batch_size
        return csv_batches(
            ds, args.batch_size, model_cfg.vision.image_size,
            get_tokenizer(model_cfg.text.context_length), epoch=epoch,
            seed=args.seed,
            train_transform=build_train_transform(args, model_cfg),
        ), steps
    if dataset_type == "webdataset":
        from ..data.wds import (
            ShardedTarDataset,
            decode_raw_image_text,
            wds_batches,
        )

        weights = None
        if args.train_data_upsampling_factors:
            weights = [float(w) for w in
                       args.train_data_upsampling_factors.split("::")]
        ds = ShardedTarDataset(
            args.train_data if len(args.train_data) > 1
            else args.train_data[0],
            decode=decode_raw_image_text, seed=args.seed,
            resampled=args.dataset_resampled, weights=weights,
            sample_shuffle_size=args.wds_shuffle_buffer,
        )
        steps = max(args.train_num_samples // args.batch_size, 1)
        from ..text.tokenizer import get_tokenizer

        batches = wds_batches(
            ds, args.batch_size, image_size=model_cfg.vision.image_size,
            tokenizer=get_tokenizer(model_cfg.text.context_length),
            epoch=epoch, seed=args.seed,
            train_transform=build_train_transform(args, model_cfg),
        )
        return batches, steps
    if dataset_type == "synthetic":
        from ..data.synthetic import synthetic_batches

        steps = max(args.train_num_samples // args.batch_size, 1)
        return synthetic_batches(
            args.batch_size,
            model_cfg.vision.image_size,
            model_cfg.text.context_length,
            num_batches=steps,
            hard_negatives=args.batch_size // 4 if args.usehardtext else 0,
            seed=args.seed,
        ), steps
    from ..data.datamix import DataMixDataset, datamix_batches
    from ..data.hard_negatives import HardNegativeAugmenter

    aug = None
    if args.usehardtext:
        aug = HardNegativeAugmenter(augfiles=args.augfiles) if args.augfiles \
            else __import__(
                "clip_embeds.data.hard_negatives", fromlist=["x"]
            ).leftright_augmenter(args.seed)
    ds = DataMixDataset(
        args.train_data,
        {"lcs558k": args.lcs_root, "datamix665k": args.datamix_root},
        image_size=model_cfg.vision.image_size,
        augmenter=aug,
        seed=args.seed,
        train_transform=build_train_transform(args, model_cfg),
    )
    steps = len(ds) // args.batch_size
    return datamix_batches(
        ds, args.batch_size,
        max_hard_per_batch=args.batch_size // 4 if args.usehardtext else 0,
        seed=args.seed, epoch=epoch,
    ), steps


def build_val_batches(args, model_cfg):
    """Held-out pair batches for the in-training evaluate() loop.

    csv/tsv (deterministic order, no shuffle) or wds tar by extension —
    the reference's val_data contract (data.py get_data val branch)."""
    from ..text.tokenizer import get_tokenizer

    ext = args.val_data.split(".")[-1]
    if ext in ("csv", "tsv"):
        from ..data.csv_dataset import CsvPairDataset, csv_batches

        ds = CsvPairDataset(
            args.val_data, img_key=args.csv_img_key,
            caption_key=args.csv_caption_key, sep=args.csv_separator,
        )
        return csv_batches(
            ds, args.batch_size, model_cfg.vision.image_size,
            get_tokenizer(model_cfg.text.context_length),
            shuffle=False, drop_last=False,
        )
    from ..data.wds import (
        ShardedTarDataset,
        decode_raw_image_text,
        wds_batches,
    )

    ds = ShardedTarDataset(
        args.val_data, decode=decode_raw_image_text, shuffle_shards=False,
    )
    return wds_batches(
        ds, args.batch_size, image_size=model_cfg.vision.image_size,
        tokenizer=get_tokenizer(model_cfg.text.context_length),
        drop_last=False,
    )


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import jax
    import jax.numpy as jnp

    from ..core import checkpoint as ckpt
    from ..core.factory import create_model
    from ..parallel.mesh import (
        batch_sharding,
        create_mesh,
        replicated_sharding,
    )
    from ..train.optim import adamw
    from ..train.schedules import const_lr, const_lr_cooldown, cosine_lr
    from ..train.steps import TrainState, make_clip_train_step

    dtype = jnp.bfloat16 if args.precision == "bf16" else jnp.float32
    remat = args.grad_checkpointing and (
        args.grad_checkpointing_policy
        if args.grad_checkpointing_policy in ("dots", "attn") else True
    )
    model, params = create_model(
        args.model, args.pretrained, dtype=dtype,
        remat=remat, seed=args.seed,
        force_quick_gelu=args.force_quick_gelu,
        force_patch_dropout=args.force_patch_dropout,
    )
    data_iter, steps_per_epoch = build_data(args, model.cfg)
    total_steps = steps_per_epoch * args.epochs

    if args.lr_scheduler == "cosine":
        sched = cosine_lr(args.lr, args.warmup, total_steps)
    elif args.lr_scheduler == "const-cooldown":
        cooldown_steps = steps_per_epoch * (
            args.epochs_cooldown if args.epochs_cooldown else args.epochs)
        sched = const_lr_cooldown(
            args.lr, args.warmup, total_steps, cooldown_steps,
            args.lr_cooldown_power, args.lr_cooldown_end,
        )
    else:
        sched = const_lr(args.lr, args.warmup)
    if args.accum_freq > 1 and args.grad_cache_chunks <= 1:
        # the reference's --accum-freq cached-feature replay
        # (train.py:113-162) IS the GradCache algorithm; route it there —
        # gradients are exact for the full accumulated batch
        args.grad_cache_chunks = args.accum_freq
    if args.grad_cache_chunks > 1:
        if args.siglip or args.usehardtext:
            raise ValueError(
                "--accum-freq/--grad-cache-chunks supports the standard "
                "InfoNCE objective only (the cached-replay loss is "
                "clip_loss); drop --siglip/--usehardtext or the accumulation"
            )
        if args.force_patch_dropout:
            logging.warning(
                "patch dropout is disabled on the grad-cache path "
                "(the cached encode pass runs deterministically)"
            )

    tx = adamw(sched, args.beta1, args.beta2, args.eps, args.wd,
               max_grad_norm=args.grad_clip_norm)
    if args.lock_image or args.lock_text:
        import optax

        from ..train.freeze import tower_freeze_labels

        labels = tower_freeze_labels(
            params, model.cfg,
            lock_image=args.lock_image,
            lock_image_unlocked_groups=args.lock_image_unlocked_groups,
            lock_text=args.lock_text,
            lock_text_unlocked_layers=args.lock_text_unlocked_layers,
            lock_text_freeze_layer_norm=args.lock_text_freeze_layer_norm,
        )
        tx = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()}, labels
        )
    state = TrainState.create(params, tx)

    start_epoch = 0
    if args.resume and args.checkpoint_dir:
        target = {"params": state.params, "step": np.asarray(0)}
        restored = (
            ckpt.resume(args.checkpoint_dir, target)
            if args.resume == "latest" else ckpt.load(args.resume, target)
        )
        if restored is not None:
            state = state.replace(params=restored["params"])
            start_epoch = int(restored["step"])
            logging.info("resumed at epoch %d", start_epoch)

    n_dev = len(jax.devices())
    mesh = create_mesh(n_dev, 1)
    sharding = batch_sharding(mesh)
    if args.fsdp:
        from ..parallel.sharding_rules import fsdp_shard_params

        sharded_params = fsdp_shard_params(mesh, state.params)
        state = state.replace(
            params=sharded_params, opt_state=tx.init(sharded_params)
        )
    else:
        # the step's outputs come back replicated over the mesh; committing
        # the first state the same way keeps step 2 from recompiling
        state = jax.device_put(state, replicated_sharding(mesh))
    # --distill is active when both teacher flags are set (main.py:208)
    distill = args.distill_model is not None and \
        args.distill_pretrained is not None
    if distill:
        from ..train.steps import make_distill_train_step

        teacher_model, teacher_params = create_model(
            args.distill_model, args.distill_pretrained, dtype=dtype,
        )
        teacher_params = jax.device_put(teacher_params)
        distill_step = jax.jit(
            make_distill_train_step(model, teacher_model), donate_argnums=0
        )
        step_fn = lambda state, batch: distill_step(  # noqa: E731
            state, teacher_params, batch
        )
    elif type(model).__name__ == "CoCa":
        from ..train.steps import make_coca_train_step

        step_fn = jax.jit(make_coca_train_step(
            model,
            caption_loss_weight=args.coca_caption_loss_weight,
            clip_loss_weight=args.coca_contrastive_loss_weight,
        ), donate_argnums=0)
    else:
        step_fn = jax.jit(make_clip_train_step(
            model, use_siglip=args.siglip, use_hard_text=args.usehardtext,
            grad_cache_chunks=args.grad_cache_chunks, seed=args.seed,
        ), donate_argnums=0)

    # metrics fan-out (reference --report-to; core/logging_utils.py)
    writer = None
    if args.report_to or args.logs:
        from ..core.logging_utils import MetricsLogger

        run_name = args.name or time.strftime("run-%Y%m%d-%H%M%S")
        log_dir = os.path.join(args.logs, run_name) if args.logs else None
        writer = MetricsLogger(
            log_dir=log_dir,
            report_to=[r for r in args.report_to.split(",") if r],
            run_name=run_name,
        )

    eval_apply = jax.jit(lambda p, im, tx: model.apply(
        {"params": p}, im, tx))
    eval_encode_text = jax.jit(lambda p, tx: model.apply(
        {"params": p}, tx, normalize=True, method="encode_text"))
    eval_encode_image = jax.jit(lambda p, im: model.apply(
        {"params": p}, im, normalize=True, method="encode_image"))

    def run_validation(epoch: int):
        """Reference evaluate() (train.py:270-377): full-val-set contrastive
        loss + image<->text retrieval metrics."""
        from ..evals.metrics import retrieval_metrics

        img_f, txt_f = [], []
        n = 0
        for vb in build_val_batches(args, model.cfg):
            out = eval_apply(state.params, vb["images"], vb["texts"])
            img_f.append(np.asarray(out["image_features"], np.float32))
            txt_f.append(np.asarray(out["text_features"], np.float32))
            n += vb["images"].shape[0]
            if n >= args.val_num_samples:
                break
        if not img_f:
            return
        img = np.concatenate(img_f)
        txt = np.concatenate(txt_f)
        scale = float(np.exp(jax.device_get(state.params["logit_scale"])))
        logits = scale * img @ txt.T
        labels = np.arange(len(img))
        # symmetric CE over the whole val set (reference val 'clip_val_loss')
        def ce(lg):
            lg = lg - lg.max(axis=1, keepdims=True)
            return float(np.mean(
                np.log(np.exp(lg).sum(axis=1)) - lg[labels, labels]
            ))
        metrics = retrieval_metrics(img, txt, scale)
        metrics["clip_val_loss"] = (ce(logits) + ce(logits.T)) / 2
        metrics["num_samples"] = float(len(img))
        logging.info("val epoch %d: %s", epoch, {
            k: round(v, 4) for k, v in metrics.items()})
        if writer:
            writer.log_eval(metrics, epoch)

    def run_zero_shot(epoch: int):
        """Mid-training ImageNet zero-shot (reference zero_shot.py via
        --zeroshot-frequency/--imagenet-val)."""
        from ..evals.zero_shot import (
            build_zero_shot_classifier,
            load_imagenet_metadata,
            zero_shot_eval,
        )
        from ..image.preprocess import preprocess_batch
        from ..text.tokenizer import get_tokenizer

        meta = load_imagenet_metadata()
        tok = get_tokenizer(model.cfg.text.context_length)

        def encode_texts(prompts):
            return np.asarray(eval_encode_text(
                state.params, jnp.asarray(tok(prompts))), np.float32)

        classifier = build_zero_shot_classifier(
            encode_texts, meta["classnames"],
            [t for t in meta["templates"]],
        )
        samples, targets = [], []
        classes = sorted(
            d for d in os.listdir(args.imagenet_val)
            if os.path.isdir(os.path.join(args.imagenet_val, d))
        )
        for ci, cls_dir in enumerate(classes):
            full = os.path.join(args.imagenet_val, cls_dir)
            for fn in sorted(os.listdir(full)):
                samples.append(os.path.join(full, fn))
                targets.append(ci)

        def encode_images(paths):
            pixels = preprocess_batch(
                list(paths), model.cfg.vision.image_size, "clip")
            return np.asarray(eval_encode_image(
                state.params, jnp.asarray(pixels)), np.float32)

        acc = zero_shot_eval(encode_images, classifier, samples, targets,
                             batch_size=args.batch_size)
        metrics = {f"imagenet-zeroshot-val-{k}": v for k, v in acc.items()}
        logging.info("zero-shot epoch %d: %s", epoch, metrics)
        if writer:
            writer.log_eval(metrics, epoch)

    # background checkpoint/log sync (reference remote_sync.py child
    # process; here a daemon thread — core/remote_sync.py)
    syncer = None
    if args.remote_sync and args.checkpoint_dir:
        from ..core.remote_sync import RemoteSync

        syncer = RemoteSync(args.checkpoint_dir, args.remote_sync,
                            every_seconds=args.remote_sync_frequency)
        syncer.start()

    prev_ckpt_step = None
    logging.info("devices=%d steps/epoch=%d", n_dev, steps_per_epoch)
    with jax.sharding.set_mesh(mesh):
        for epoch in range(start_epoch, args.epochs):
            if epoch > start_epoch or epoch > 0:
                data_iter, _ = build_data(args, model.cfg, epoch=epoch)
            t0 = time.perf_counter()
            seen = 0
            for i, batch in enumerate(data_iter):
                batch = jax.tree.map(
                    lambda x: jax.device_put(x, sharding), batch
                )
                state, metrics = step_fn(state, batch)
                seen += args.batch_size
                if (i + 1) % args.log_every == 0 or i + 1 == steps_per_epoch:
                    loss = float(metrics["loss"])  # forces the chain
                    dt = time.perf_counter() - t0
                    logging.info(
                        "epoch %d step %d loss %.4f lr %.2e "
                        "samples/s %.1f samples/s/chip %.1f",
                        epoch, i + 1, loss, float(sched(state.step)),
                        seen / dt, seen / dt / n_dev,
                    )
                    if writer:
                        writer.log({
                            "loss": loss,
                            "lr": float(sched(state.step)),
                            "samples_per_s": seen / dt,
                        }, step=int(state.step))
            done = epoch + 1
            if args.val_data and (done % args.val_frequency == 0
                                  or done == args.epochs):
                run_validation(done)
            if args.imagenet_val and (done % args.zeroshot_frequency == 0
                                      or done == args.epochs):
                run_zero_shot(done)
            if args.checkpoint_dir and (
                    (args.save_frequency > 0
                     and done % args.save_frequency == 0)
                    or done == args.epochs or args.save_most_recent):
                ckpt.save(
                    args.checkpoint_dir,
                    {"params": jax.device_get(state.params),
                     "step": np.asarray(done)},
                    step=done, blocking=not args.async_checkpoints,
                )
                # --delete-previous-checkpoint / the transient
                # --save-most-recent copy (reference main.py:480-504)
                if prev_ckpt_step is not None and (
                        args.delete_previous_checkpoint
                        or (args.save_most_recent
                            and (args.save_frequency <= 0
                                 or prev_ckpt_step % args.save_frequency
                                 != 0))):
                    import shutil

                    # (async: orbax AsyncCheckpointer serializes saves —
                    # by the time save(N) returned, save(N-1) had committed,
                    # so pruning the previous dir here is safe without a wait)

                    old = os.path.join(
                        args.checkpoint_dir,
                        f"{ckpt.CKPT_PREFIX}{prev_ckpt_step}")
                    if os.path.isdir(old):
                        shutil.rmtree(old, ignore_errors=True)
                prev_ckpt_step = done
    ckpt.wait_for_saves()
    if syncer is not None:
        syncer.stop(final_sync=True)
    logging.info("done: %d steps", int(state.step))
    return state


if __name__ == "__main__":
    main()
