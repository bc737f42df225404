"""PACL / SPARC head-training driver.

JAX equivalent of the reference experiment scripts
(Patch-Aligned-Contrastive-Learning/train_pacl.py:78-135 and
train_sparc.py): a frozen CLIP tower feeds trainable patch/text projection
heads; PACL optimizes in-batch InfoNCE at fixed T=0.1 (ClipLoss(temperature=
0.1), train_pacl.py:106), SPARC the global+local grouped-patch objective.
Optimizer matches the reference: Adam, lr 1e-4, no schedule.

Usage (LCS-558K-style annotations; --synthetic for a smoke run):
  python -m clip_embeds.cli.train_pacl --objective pacl \
      --model ViT-L-14-336 --pretrained /ckpt.pt \
      --data blip_laion_cc_sbu_558k.json --image-roots /data/llava \
      [--embed-paths single_embed.npy]   # LLM2CLIP-PACL variant \
      --epochs 10 --batch-size 4096 --output pacl_head.npz
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--objective", default="pacl", choices=["pacl", "sparc"])
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--proj-dim", type=int, default=768)
    p.add_argument("--rope", default="none",
                   choices=["none", "before", "after"],
                   help="PACL RoPE ablation / SPARC rope (any non-'none')")
    p.add_argument("--pooling", default="weighted",
                   choices=["weighted", "uniform"],
                   help="PACL train-time patch pooling (eval uses the "
                        "committed uniform quirk)")
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--data", nargs="*", default=None,
                   help="LLaVA-format annotation json files")
    p.add_argument("--image-roots", nargs="*", default=None)
    p.add_argument("--embed-paths", nargs="*", default=None,
                   help="precomputed LLM text-embedding .npy per annotation "
                        "file (LLM2CLIP-PACL)")
    p.add_argument("--synthetic", action="store_true",
                   help="random pairs instead of real data (smoke runs)")
    p.add_argument("--train-num-samples", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--sparc-sigma", type=float, default=None,
                   help="patch-grouping threshold (default 1/num_patches)")
    p.add_argument("--sparc-global-weight", type=float, default=0.5)
    p.add_argument("--sparc-local-weight", type=float, default=1.0)
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"])
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--output", default=None, help="head params .npz path")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _synthetic_batches(args, image_size, context_length, embed_dim=None):
    rng = np.random.default_rng(args.seed)
    steps = max(args.train_num_samples // args.batch_size, 1)
    for _ in range(steps):
        batch = {
            "images": rng.standard_normal(
                (args.batch_size, image_size, image_size, 3)
            ).astype(np.float32),
            "texts": np.concatenate([
                np.full((args.batch_size, 1), 49406),
                rng.integers(1000, 40000,
                             (args.batch_size, context_length - 2)),
                np.full((args.batch_size, 1), 49407),
            ], axis=1).astype(np.int32),
        }
        if embed_dim:
            batch["text_embeddings"] = rng.standard_normal(
                (args.batch_size, embed_dim)).astype(np.float32)
        yield batch


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import jax
    import jax.numpy as jnp

    from ..core.factory import create_model
    from ..losses.clip_loss import pacl_clip_loss
    from ..losses.sparc import sparc_group_patches, sparc_loss
    from ..models.heads import (
        PACLHead,
        SPARCHead,
        language_mask_from_ids,
    )
    from ..train.steps import TrainState, make_frozen_tower_train_step

    dtype = jnp.bfloat16 if args.precision == "bf16" else jnp.float32
    model, clip_params = create_model(
        args.model, args.pretrained, dtype=dtype, seed=args.seed,
    )
    cfg = model.cfg
    num_patches = cfg.vision.num_patches

    use_llm_embeds = bool(args.embed_paths)
    if args.objective == "pacl":
        head = PACLHead(
            proj_dim=args.proj_dim, rope=args.rope,
            pooling=args.pooling, dropout=args.dropout, dtype=dtype,
        )
    else:
        head = SPARCHead(
            proj_dim=args.proj_dim, rope=args.rope != "none",
            dropout=args.dropout, dtype=dtype,
        )
    sigma = (args.sparc_sigma if args.sparc_sigma is not None
             else 1.0 / num_patches)

    # frozen-tower features (params as jit args; output_tokens taps)
    def frozen_features(clip_p, batch):
        _, patches = model.apply(
            {"params": clip_p}, batch["images"].astype(dtype),
            output_tokens=True, method="encode_image",
        )
        if args.objective == "sparc":
            _, tok = model.apply(
                {"params": clip_p}, batch["texts"], output_tokens=True,
                method="encode_text",
            )
            return patches, tok
        if use_llm_embeds or "text_embeddings" in batch:
            return patches, batch["text_embeddings"].astype(dtype)
        txt = model.apply(
            {"params": clip_p}, batch["texts"], method="encode_text",
        )
        return patches, txt

    def loss_of_params(head_params, feats, batch):
        patches, text_feat = feats
        if args.objective == "pacl":
            img_f, txt_f = head.apply(
                {"params": head_params}, patches, text_feat, train=True,
                rngs={"dropout": jax.random.fold_in(
                    jax.random.PRNGKey(args.seed), batch["_step"])},
            )
            loss = pacl_clip_loss(img_f, txt_f, args.temperature)
            return loss, {}
        vproj, tproj = head.apply(
            {"params": head_params}, patches, text_feat, train=True,
            rngs={"dropout": jax.random.fold_in(
                jax.random.PRNGKey(args.seed), batch["_step"])},
        )
        from ..models.clip import l2_normalize

        tnorm = l2_normalize(tproj)
        # reference pacl.py:475 normalizes the grouped embeddings before the
        # local InfoNCE (sparc_loss's contract; parity test does the same)
        grouped = l2_normalize(sparc_group_patches(vproj, tnorm, sigma=sigma))
        mask = language_mask_from_ids(batch["texts"]).astype(jnp.float32)
        loss = sparc_loss(
            vproj, tnorm, grouped, mask,
            temperature=args.temperature,
            global_weight=args.sparc_global_weight,
            local_weight=args.sparc_local_weight,
        )
        return loss, {}

    # init the head on one example shape
    if args.synthetic or not args.data:
        if not args.synthetic:
            raise SystemExit("--data (+ --image-roots) or --synthetic needed")
        embed_dim = 4096 if use_llm_embeds else None
        batches = lambda epoch=0: _synthetic_batches(  # noqa: E731
            args, cfg.vision.image_size, cfg.text.context_length, embed_dim)
    else:
        from ..data.pacl_data import PACLCaptionDataset, pacl_batches
        from ..text.tokenizer import get_tokenizer

        ds = PACLCaptionDataset(
            args.data, args.image_roots or ["."] * len(args.data),
            image_size=cfg.vision.image_size,
            embed_paths=args.embed_paths, seed=args.seed,
        )
        tok = get_tokenizer(cfg.text.context_length)
        batches = lambda epoch=0: pacl_batches(  # noqa: E731
            ds, args.batch_size, tokenizer=tok, seed=args.seed, epoch=epoch)

    first = jax.tree.map(jnp.asarray, next(iter(batches())))
    clip_params = jax.device_put(clip_params)

    tower_fn = jax.jit(frozen_features)
    patches, text_feat = tower_fn(clip_params, first)
    head_params = head.init(
        jax.random.PRNGKey(args.seed), np.asarray(patches),
        np.asarray(text_feat),
    )["params"]

    import optax

    state = TrainState.create(head_params, optax.adam(args.lr))
    step = jax.jit(make_frozen_tower_train_step(loss_of_params))

    n_params = sum(x.size for x in jax.tree.leaves(head_params))
    logging.info("objective=%s trainable head params=%d (frozen tower: %s)",
                 args.objective, n_params, args.model)
    global_step = 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        seen = 0
        for i, batch in enumerate(batches(epoch)):
            batch = jax.tree.map(jnp.asarray, batch)
            # feats first: tower_fn's jit signature stays identical to the
            # startup/gate call (no "_step" leaf -> no retrace)
            feats = tower_fn(clip_params, batch)
            batch["_step"] = jnp.asarray(global_step, jnp.int32)
            global_step += 1
            state, metrics = step(state, feats, batch)
            seen += args.batch_size
            if (i + 1) % args.log_every == 0 or i == 0:
                logging.info(
                    "epoch %d step %d loss %.4f samples/s %.1f",
                    epoch, i + 1, float(metrics["loss"]),
                    seen / (time.perf_counter() - t0),
                )
    if args.output:
        from ..core.factory import save_params_npz

        save_params_npz(jax.device_get(state.params), args.output)
        logging.info("saved head -> %s", args.output)
    return state


if __name__ == "__main__":
    main()
