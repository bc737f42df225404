"""W8A8 accuracy validation: int8 vs bf16 embeddings, cross-distribution.

The int8 serving path (the composable QuantDense-static model,
models/quant.py) uses static activation scales calibrated on a sample
batch. This command quantifies what that costs:
for every (calibration distribution) x (evaluation distribution) pair it
reports the int8-vs-bf16 embedding cosine (mean/min) and the top-1
nearest-neighbour agreement against the bf16 gallery — the argmax-level
metric the accuracy benchmarks actually consume.

Zero-egress default: random-init weights on the real serving architecture
with synthetic distributions (uniform noise / smooth natural-spectrum
composites / hard-edged charts). The documented ONE-COMMAND revalidation for
when real weights and data arrive:

    python -m clip_embeds.cli.validate_int8 --model ViT-L-14-336 \
        --pretrained /path/openai_vitl336.pt --images /path/real_photos \
        --out int8_report.json

Exit code 1 if any pair falls below --min-cos / --min-agreement.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds int8 validation")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--images", default=None,
                   help="directory of real images (adds a 'photos' distribution)")
    p.add_argument("--distributions", default="noise,smooth,charts")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--min-cos", type=float, default=0.99)
    p.add_argument("--min-agreement", type=float, default=0.98)
    p.add_argument("--out", default=None)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def make_batch(dist: str, n: int, size: int, rng,
               image_dir=None) -> np.ndarray:
    """uint8 [n, size, size, 3] samples of the named distribution."""
    if dist == "noise":
        return rng.integers(0, 255, (n, size, size, 3), np.uint8)
    if dist == "smooth":
        # natural-image-like 1/f spectrum: sum of low-frequency gradients
        yy, xx = np.mgrid[0:size, 0:size] / size
        out = np.zeros((n, size, size, 3), np.float32)
        for i in range(n):
            for c in range(3):
                img = np.zeros((size, size), np.float32)
                for k in range(1, 6):
                    fx, fy = rng.uniform(0, 3, 2)
                    ph = rng.uniform(0, 2 * np.pi)
                    img += np.sin(2 * np.pi * (fx * xx + fy * yy) + ph) / k
                out[i, :, :, c] = img
        out -= out.min(axis=(1, 2, 3), keepdims=True)
        out /= out.max(axis=(1, 2, 3), keepdims=True) + 1e-8
        return (out * 255).astype(np.uint8)
    if dist == "charts":
        # hard edges + flat regions (text/diagram-like statistics)
        out = np.full((n, size, size, 3), 255, np.uint8)
        for i in range(n):
            for _ in range(12):
                x0, y0 = rng.integers(0, size - 4, 2)
                w, h = rng.integers(2, size // 2, 2)
                color = rng.integers(0, 255, 3)
                out[i, y0:y0 + h, x0:x0 + w] = color
        return out
    if dist == "photos":
        from PIL import Image

        from .embed import list_images

        paths = list_images(image_dir)[:n]
        if not paths:
            raise FileNotFoundError(f"no images under {image_dir}")
        imgs = []
        for path in paths:
            im = Image.open(path).convert("RGB").resize((size, size))
            imgs.append(np.asarray(im, np.uint8))
        while len(imgs) < n:
            imgs.append(imgs[len(imgs) % len(paths)])
        return np.stack(imgs)
    raise KeyError(dist)


def _cosine(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


def main(argv=None):
    args = parse_args(argv)

    import jax
    import jax.numpy as jnp

    from ..core.factory import create_model
    from ..image.preprocess import jax_preprocess

    dtype = jnp.bfloat16
    model, params = create_model(args.model, pretrained=args.pretrained,
                                 dtype=dtype, seed=args.seed)
    size = model.cfg.vision.image_size
    rng = np.random.default_rng(args.seed)
    dists = [d for d in args.distributions.split(",") if d]
    if args.images:
        dists.append("photos")
    batches = {
        d: make_batch(d, args.batch_size, size, rng, args.images)
        for d in dists
    }

    params = jax.device_put(params)

    @jax.jit
    def embed_bf16(params, raw):
        pixels = jax_preprocess(raw, size, "clip", dtype)
        return model.apply({"params": params}, pixels, normalize=True,
                           method="encode_image")

    bf16_embeds = {
        d: np.asarray(embed_bf16(params, jnp.asarray(b)),
                      np.float32)
        for d, b in batches.items()
    }

    def build_int8(calib_raw):
        """Calibrate on one batch; return embed(raw) for the int8 path."""
        from ..models.clip import CLIP
        from ..models.quant import calibrate_act_scales, quantize_dense_tree

        calib_px = jax_preprocess(
            jnp.asarray(calib_raw), size, "clip", jnp.float32)
        qparams = quantize_dense_tree(jax.device_get(params))
        dyn = CLIP(model.cfg, dtype=jnp.float32, quant=True,
                   attn_impl="reference")
        sparams = calibrate_act_scales(
            dyn, qparams, [(calib_px,)],
            apply_kwargs={"method": "encode_image"},
        )
        smodel = CLIP(model.cfg, dtype=dtype, quant="static")
        sparams = jax.device_put(sparams)

        @jax.jit
        def embed_q(p, raw):
            px = jax_preprocess(raw, size, "clip", dtype)
            return smodel.apply({"params": p}, px, normalize=True,
                                method="encode_image")

        return lambda raw: np.asarray(embed_q(sparams, jnp.asarray(raw)),
                                      np.float32)

    report: Dict = {"model": args.model, "pretrained": args.pretrained,
                    "pairs": []}
    ok = True
    for calib in dists:
        embed_q = build_int8(batches[calib])
        for ev in dists:
            q = embed_q(batches[ev])
            ref = bf16_embeds[ev]
            cos = _cosine(q, ref)
            # top-1 NN agreement against the bf16 gallery of the same batch
            sim_q = q @ ref.T
            sim_ref = ref @ ref.T
            np.fill_diagonal(sim_q, -np.inf)
            np.fill_diagonal(sim_ref, -np.inf)
            agree = float(
                (sim_q.argmax(-1) == sim_ref.argmax(-1)).mean()
            )
            row = {
                "calibration": calib, "eval": ev,
                "cos_mean": float(cos.mean()), "cos_min": float(cos.min()),
                "top1_agreement": agree,
            }
            row["pass"] = (row["cos_mean"] >= args.min_cos
                           and agree >= args.min_agreement)
            ok = ok and row["pass"]
            report["pairs"].append(row)
            print(f"calib={calib:7s} eval={ev:7s} "
                  f"cos mean {row['cos_mean']:.4f} min {row['cos_min']:.4f} "
                  f"top1 agree {agree:.3f} "
                  f"{'OK' if row['pass'] else 'BELOW THRESHOLD'}",
                  flush=True)
    report["pass"] = ok
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
