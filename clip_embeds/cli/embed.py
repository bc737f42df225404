"""Batch image-embedding serving driver.

The reference's eval loops preprocess one PIL image per model call inside the
scoring loop (eval_clip.py:50-65) — the host-device ping-pong SURVEY.md §7
flags as the throughput killer. This driver is the production path instead:

  * the C++ pipeline (native/decode.cpp) reads, decodes (JPEG/PNG/WebP),
    resizes, crops and normalizes whole batches GIL-free ahead of the
    device, with per-slot PIL fallback for exotic formats
    (image/loader.py PrefetchLoader; --fast-jpeg enables DCT-domain
    downscaled decode for another ~1.5x host throughput)
  * batches are dispatched asynchronously — JAX's async dispatch keeps the
    device busy on batch i while the host prepares batch i+1 (double
    buffering)
  * embeddings land in one [N, D] .npy plus a path manifest

Usage:
  python -m clip_embeds.cli.embed --model ViT-L-14-336 \
      --pretrained /ckpt.pt --input /data/images --output emb.npy \
      [--batch-size 256] [--int8] [--bf16] [--fast-jpeg]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np

from ..image.loader import PrefetchLoader

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_images(root: str) -> List[str]:
    if os.path.isfile(root) and not root.lower().endswith(tuple(IMAGE_EXTS)):
        # manifest file: one path per line
        with open(root) as fh:
            return [ln.strip() for ln in fh if ln.strip()]
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if os.path.splitext(fn)[1].lower() in IMAGE_EXTS:
                out.append(os.path.join(dirpath, fn))
    return out


def int8_static_model(model, params, calib, dtype, method="encode_image"):
    """(static W8A8 CLIP, its params): int8 weights (models/quant.py
    QuantDense) and activation scales calibrated by abs-max over ``calib``,
    the input of ``method`` (pixels [N, S, S, 3] or token ids [N, L])."""
    import jax

    from ..models.clip import CLIP
    from ..models.quant import calibrate_act_scales, quantize_dense_tree

    qparams = quantize_dense_tree(jax.device_get(params))
    dyn = CLIP(model.cfg, dtype=dtype, quant=True, attn_impl="reference")
    sparams = calibrate_act_scales(
        dyn, qparams, [(calib,)], apply_kwargs={"method": method},
    )
    return CLIP(model.cfg, dtype=dtype, quant="static"), sparams


def _embed_texts(args, model, params, dtype) -> int:
    """Text-tower serving: one caption per line -> [N, D] .npy."""
    import jax
    import jax.numpy as jnp

    from ..text.tokenizer import get_tokenizer

    with open(args.input_texts) as fh:
        texts = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if not texts:
        print(f"no texts in {args.input_texts}", file=sys.stderr)
        return 1
    tokenizer = get_tokenizer(model.cfg.text.context_length)
    bundle = jax.device_put(params)
    encode = jax.jit(lambda p, ids: model.apply(
        {"params": p}, ids, normalize=True, method="encode_text"))

    bs = args.batch_size
    t0 = time.perf_counter()
    outputs = []
    for start in range(0, len(texts), bs):
        chunk = texts[start : start + bs]
        tail = len(chunk)
        if tail < bs:
            chunk = chunk + [chunk[-1]] * (bs - tail)
        ids = jnp.asarray(tokenizer(chunk))
        outputs.append(encode(bundle, ids)[:tail])
    embs = np.concatenate(
        [np.asarray(o, dtype=np.float32) for o in outputs], axis=0
    )
    elapsed = time.perf_counter() - t0
    np.save(args.output, embs)
    print(json.dumps({
        "texts": len(texts),
        "dim": int(embs.shape[1]),
        "seconds": round(elapsed, 3),
        "texts_per_sec": round(len(texts) / elapsed, 2),
        "output": args.output,
    }))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="ViT-L-14-336")
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--input", default=None,
                    help="image directory, single image, or manifest file")
    ap.add_argument("--input-texts", default=None,
                    help="text file (one caption per line) -> text-tower "
                    "embeddings instead of image embeddings")
    ap.add_argument("--output", required=True, help=".npy output path")
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--int8", action="store_true",
                    help="int8 W8A8 serving path (models/quant.py)")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--fast-jpeg", action="store_true",
                    help="DCT-domain downscaled JPEG decode (faster host "
                    "pipeline; pixels deviate slightly from PIL-exact)")
    ap.add_argument("--data-parallel", action="store_true", default=None,
                    help="shard batches over all devices (default: auto "
                    "when more than one device is visible)")
    ap.add_argument("--no-data-parallel", dest="data_parallel",
                    action="store_false")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..core.factory import create_model

    if (args.input is None) == (args.input_texts is None):
        print("exactly one of --input / --input-texts is required",
              file=sys.stderr)
        return 1

    dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    model, params = create_model(
        args.model, pretrained=args.pretrained, dtype=dtype,
    )
    if args.input_texts is not None:
        return _embed_texts(args, model, params, dtype)
    size = model.cfg.vision.image_size
    calibrated = {"done": not args.int8}

    # data-parallel serving: replicate params, shard the batch axis over the
    # device mesh — XLA keeps every chip busy and the host sees one array
    n_dev = len(jax.devices())
    use_dp = (args.data_parallel if args.data_parallel is not None
              else n_dev > 1)
    if use_dp and args.batch_size % n_dev != 0:
        args.batch_size = max(n_dev, args.batch_size // n_dev * n_dev)
        print(f"batch size rounded to {args.batch_size} "
              f"({n_dev}-device data parallel)", file=sys.stderr)

    if use_dp and n_dev > 1:
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(jax.devices()), ("data",))
        batch_sharding = NamedSharding(mesh, P("data"))
        replicated = NamedSharding(mesh, P())

        def jit_embed(fn):
            # (params, pixels) -> embeddings: params replicated, batch sharded
            return jax.jit(
                fn,
                in_shardings=(replicated, batch_sharding),
                out_shardings=batch_sharding,
            )
    else:
        def jit_embed(fn):
            return jax.jit(fn)

    embed = jit_embed(lambda params, pixels: model.apply(
        {"params": params}, pixels.astype(dtype), normalize=True,
        method="encode_image",
    ))

    def maybe_calibrate_int8(first_batch: np.ndarray):
        """Swap in the static W8A8 model, calibrated on the first real
        batch (abs-max calibration needs only a handful of images)."""
        nonlocal model, params, embed
        model, params = int8_static_model(
            model, params, jnp.asarray(first_batch[:16]), dtype)
        params = jax.device_put(params)
        embed = jit_embed(lambda p, px: model.apply(
            {"params": p}, px.astype(dtype), normalize=True,
            method="encode_image",
        ))
        calibrated["done"] = True

    paths = list_images(args.input)
    if not paths:
        print(f"no images under {args.input}", file=sys.stderr)
        return 1

    bs = args.batch_size
    t0 = time.perf_counter()
    kept_paths: List[str] = []
    outputs = []  # device arrays; fetch lazily (async dispatch pipeline)

    # The C++ loader decodes batch i+1 in a background thread while the
    # device runs batch i; corrupt files are dropped (wds log_and_continue
    # semantics), so device batches repack across loader batches.
    loader = PrefetchLoader(
        paths, batch_size=bs, image_size=size,
        fast_jpeg=args.fast_jpeg, num_threads=args.workers,
    )
    batch: List[np.ndarray] = []
    for chunk, arrs, ok in loader:
        for path, arr, good in zip(chunk, arrs, ok):
            if not good:
                print(f"skip {path}: undecodable", file=sys.stderr)
                continue
            kept_paths.append(path)
            batch.append(arr)
            if len(batch) == bs:
                stacked = np.stack(batch)
                if not calibrated["done"]:
                    maybe_calibrate_int8(stacked)
                outputs.append(embed(params, jnp.asarray(stacked)))
                batch = []
    if batch:
        if not calibrated["done"]:
            maybe_calibrate_int8(np.stack(batch))
        # pad the tail batch to the static shape, slice after
        tail = len(batch)
        batch += [batch[-1]] * (bs - tail)
        outputs.append(
            embed(params, jnp.asarray(np.stack(batch)))[:tail]
        )
    embs = np.concatenate(
        [np.asarray(o, dtype=np.float32) for o in outputs], axis=0
    )
    elapsed = time.perf_counter() - t0

    np.save(args.output, embs)
    with open(args.output + ".paths.json", "w") as fh:
        json.dump(kept_paths, fh)
    print(json.dumps({
        "images": len(kept_paths),
        "dim": int(embs.shape[1]),
        "seconds": round(elapsed, 3),
        "images_per_sec": round(len(kept_paths) / elapsed, 2),
        "output": args.output,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
