#!/usr/bin/env python3
"""Smoke test of the main paths on the GPU, against the plain reference.

    python chip_smoke.py           # one GPU: the phases below
    python chip_smoke.py --multi   # four GPUs: data-parallel paths only

One GPU, ViT-L/14-336 at full width with random weights from a seed:

  1 device      JAX's platform must be 'gpu'; there is no CPU fallback.
  2 attention   the attention dispatch (ops/attention.py) at the vision,
                text, LLaVA prefill and masked suffix shapes, forward and
                gradient, against an fp32 reference_attention: in bf16
                (cuDNN), and in fp32 through the cuDNN route's plumbing in
                its XLA form; the bf16 reference's own error beside it; and
                the time of the reference, jax.nn XLA and cuDNN versions.
  3 image       clip_embeds.cli.embed over 512 PNGs this script writes,
                decoded by the native library; the first rows against an
                fp32 reference forward; the bf16 tower's rate.
  4 text        the same CLI with --input-texts.
  5 int8        the CLI with --int8 against the bf16 embeddings; the W8A8
                tower's rate.
  6 train       a few steps of clip_embeds.cli.train: the loss stays finite
                and the step compiles once.
  7 vqascore    VQAScore over LLaVA-1.5-7B widths, trunk cut to 2 layers:
                the image-KV-prefix path against the per-pair path, in
                score and in log score.

--multi runs, on four GPUs: one step of the step function cli.train jits
(make_clip_train_step, AdamW) on the dp=4 mesh against the same step on one
card from the same state, comparing the loss, the gradient (AdamW's first
moments) and the updated params; a few steps of clip_embeds.cli.train on
the four GPUs; and the SigLIP ppermute ring against one card.

Each phase prints one line; times and rates carry the card's name and power
limit. The script exits nonzero if any phase fails; only then is the last
line not the JSON object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import zlib

import numpy as np

MODEL = "ViT-L-14-336"
N_IMAGES = 512
N_TEXTS = 1024
BATCH = 256
TRAIN_BATCH = 64
TRAIN_STEPS = 4
ROWS_CHECKED = 8
COS_MIN = 0.999        # bf16 embeddings against the fp32 reference
INT8_COS_MIN = 0.99    # W8A8 against bf16, mean over rows
# attention against the fp32 reference: |got - want| <= atol + rtol |want|.
# bf16 spaces values in [2, 4) by 2^-6, so rounding the output alone
# exceeds 2e-2 above ~2.5: the relative term (two bf16 half-ulps) covers it.
ATTN_TOL = {"bfloat16": (2e-2, 2 ** -7), "float32": (1e-5, 0.0)}
VQA_TOL = 1e-3
VQA_LOG_TOL = 1e-2
MULTI_LOSS_RTOL = 5e-3
MULTI_GRAD_COS = 0.999
MULTI_GRAD_NORM_RTOL = 1e-2  # a sum over devices where a mean belongs: x4
# AdamW's first step moves each weight by about lr * sign(gradient): the
# weights whose gradient is within bf16 noise of zero may step either way
MULTI_UPDATE_COS = 0.9


# -- inputs made here --------------------------------------------------------

def png_bytes(rgb: np.ndarray) -> bytes:
    """8-bit RGB PNG (filter 0 on every row) built with zlib and struct."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def synthetic_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth gradients plus noise, uint8 [h, w, 3]."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(0.005, 0.05, (3, 2))
    img = np.stack([127 + 90 * np.sin(x * f[c, 0] + c) * np.cos(y * f[c, 1])
                    for c in range(3)], axis=-1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_pngs(root: str, n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(300, 480, 2))
        path = os.path.join(root, f"img_{i:04d}.png")
        with open(path, "wb") as fh:
            fh.write(png_bytes(synthetic_image(rng, h, w)))
        paths.append(path)
    return paths


def captions(n: int, seed: int = 0) -> list:
    words = ("a photo of the red blue green small large dog cat car tree "
             "house person bicycle on in under next to with two three "
             "sitting running street beach table").split()
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(3, 16))))
            for _ in range(n)]


# -- measurement helpers -----------------------------------------------------

def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def seconds_per_call(fn, *args, iters: int = 10) -> float:
    """Median over 3 windows of `iters` calls, each ended by
    block_until_ready; the first call (compile) is not timed."""
    import jax

    jax.block_until_ready(fn(*args))
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        windows.append((time.perf_counter() - t0) / iters)
    return float(np.median(windows))


def row_cosine(a, b) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def flat64(tree) -> np.ndarray:
    """Every leaf of a pytree, raveled into one float64 vector."""
    import jax

    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in jax.tree.leaves(tree)])


def cosine(x: np.ndarray, y: np.ndarray) -> float:
    return float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))


def run_cli(main, argv) -> dict:
    """Run a CLI main(); return the JSON object of its last stdout line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc:
        raise RuntimeError(f"{main.__module__} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# -- phases ------------------------------------------------------------------

def attention_shapes():
    """(name, batch, heads, q len, kv len, head dim, causal, masked)."""
    return [
        ("vit_l14_336", 256, 16, 577, 577, 64, False, False),
        ("clip_text", 256, 12, 77, 77, 64, True, False),
        ("llava_prefill", 8, 32, 640, 640, 128, True, False),
        # 4 candidate suffixes of 32 tokens concatenated over a 640-token
        # prefix, block-diagonal causal (models/llama.py suffix_block)
        ("llava_suffix", 8, 32, 128, 768, 128, False, True),
    ]


def suffix_mask(b, n_texts, ls, p):
    import jax.numpy as jnp

    n = n_texts * ls
    i = jnp.arange(n)[:, None]
    j = jnp.arange(p + n)[None, :]
    js = j - p
    m = (j < p) | ((js <= i) & ((js // ls) == (i // ls)))
    return jnp.broadcast_to(m[None, None], (b, 1, n, p + n))


def phase_attention(ctx, gpu):
    import jax
    import jax.numpy as jnp

    from clip_embeds.ops.attention import (
        attention_route,
        dot_product_attention,
        reference_attention,
    )

    def bhnd(t):  # models hold [B, N, H, D] and transpose (layers.py)
        return t.transpose(0, 2, 1, 3)

    versions = {
        "reference": lambda q, k, v, c, m: reference_attention(q, k, v, c, m),
        "xla": lambda q, k, v, c, m: bhnd(jax.nn.dot_product_attention(
            bhnd(q), bhnd(k), bhnd(v), mask=m, is_causal=c,
            implementation="xla")),
        "dispatch": lambda q, k, v, c, m: dot_product_attention(
            q, k, v, c, m),
    }
    summary = {}
    for name, b, h, nq, nk, d, causal, masked in attention_shapes():
        keys = jax.random.split(jax.random.PRNGKey(len(summary)), 4)
        q = jax.random.normal(keys[0], (b, nq, h, d), jnp.bfloat16)
        k = jax.random.normal(keys[1], (b, nk, h, d), jnp.bfloat16)
        v = jax.random.normal(keys[2], (b, nk, h, d), jnp.bfloat16)
        g = jax.random.normal(keys[3], (b, nq, h, d), jnp.bfloat16)
        mask = suffix_mask(b, 4, 32, 640) if masked else None
        route = attention_route(jnp.bfloat16, d, jax.default_backend())

        def fwd(f, q, k, v, m):
            return f(bhnd(q), bhnd(k), bhnd(v), causal, m)

        def loss(f, q, k, v, m, g):
            out = fwd(f, q, k, v, m).astype(jnp.float32)
            return jnp.sum(out * bhnd(g).astype(jnp.float32))

        f_ref = jax.jit(lambda q, k, v, m: fwd(versions["reference"],
                                               q, k, v, m))
        g_ref = jax.jit(jax.grad(
            lambda q, k, v, m, g: loss(versions["reference"], q, k, v, m, g),
            (0, 1, 2)))

        def excess(got, want, got_g, want_g, rtol):
            """max of |got - want| - rtol |want| (<= atol passes) and max
            |got - want|, for the output and for the gradients."""
            def one(a, w):
                d = jnp.abs(a.astype(jnp.float32) - w)
                return (float(jnp.max(d - rtol * jnp.abs(w))),
                        float(jnp.max(d)))

            fwd_x, err = one(got, want)
            bwd = [one(a, w) for a, w in zip(got_g, want_g)]
            return (fwd_x, err, max(x for x, _ in bwd),
                    max(e for _, e in bwd))

        rec = {"route": route}
        for dtype in (jnp.bfloat16, jnp.float32):
            # bf16 runs the dispatch (cuDNN on the GPU). The dispatch sends
            # fp32 to reference_attention itself, so fp32 runs the cuDNN
            # route's plumbing (layout, padding, masks) in its XLA form.
            # fp32 checks the first 8 rows: its reference materialises
            # fp32 [B, H, N, N] logits and their gradient
            impl = "auto" if dtype == jnp.bfloat16 else "xla"
            rows = b if dtype == jnp.bfloat16 else min(b, 8)
            args = [t[:rows].astype(dtype) for t in (q, k, v)]
            m = None if mask is None else mask[:rows]
            gr = g[:rows].astype(dtype)

            def under_test(q, k, v, c, m, impl=impl):
                return dot_product_attention(q, k, v, c, m, impl=impl)

            f_test = jax.jit(lambda q, k, v, m: fwd(under_test, q, k, v, m))
            g_test = jax.jit(jax.grad(
                lambda q, k, v, m, g: loss(under_test, q, k, v, m, g),
                (0, 1, 2)))
            # float32 on the GPU runs its matrix products in TF32 unless
            # asked for more; the fp32 path is checked at "highest"
            precision = "highest" if dtype == jnp.float32 else "default"
            with jax.default_matmul_precision(precision):
                got = f_test(*args, m)
                got_g = g_test(*args, m, gr)
            with jax.default_matmul_precision("highest"):
                args32 = [t.astype(jnp.float32) for t in args]
                want = f_ref(*args32, m)
                want_g = g_ref(*args32, m, gr.astype(jnp.float32))
            atol, rtol = ATTN_TOL[jnp.dtype(dtype).name]
            fwd_x, err, bwd_x, err_g = excess(got, want, got_g, want_g, rtol)
            tag = (f"{jnp.dtype(dtype).name}_"
                   f"{route if impl == 'auto' else impl}")
            rec[f"{tag}_max_abs"] = [err, err_g]
            rec[f"{tag}_excess"] = [fwd_x, bwd_x]
            check(fwd_x <= atol and bwd_x <= atol,
                  f"attention {name} {tag}: |d| - {rtol:.3g}|ref| "
                  f"fwd {fwd_x:.3g} grad {bwd_x:.3g} > {atol}")
            if dtype == jnp.bfloat16:
                want_bf16 = (want, want_g)
        # time the three versions in bf16 (forward; forward + backward)
        for vname, f in versions.items():
            f_fwd = jax.jit(lambda q, k, v, m, f=f: fwd(f, q, k, v, m))
            f_bwd = jax.jit(jax.grad(
                lambda q, k, v, m, g, f=f: loss(f, q, k, v, m, g), (0, 1, 2)))
            label = route if vname == "dispatch" else vname
            rec[f"{label}_ms"] = [
                round(1e3 * seconds_per_call(f_fwd, q, k, v, mask), 4),
                round(1e3 * seconds_per_call(f_bwd, q, k, v, mask, g), 4)]
            if vname == "reference":
                # the plain reference in bf16 against the fp32 one: the
                # error a correct bf16 attention has at this shape
                fwd_x, err, bwd_x, err_g = excess(
                    f_fwd(q, k, v, mask), want_bf16[0],
                    f_bwd(q, k, v, mask, g), want_bf16[1],
                    ATTN_TOL["bfloat16"][1])
                rec["reference_in_bf16_max_abs"] = [err, err_g]
                rec["reference_in_bf16_excess"] = [fwd_x, bwd_x]
        del want_bf16
        summary[name] = rec
        del q, k, v, g
    return {"shapes": summary, "card": gpu,
            "ms": "[forward, forward+backward]"}


def phase_image(ctx, gpu):
    import jax
    import jax.numpy as jnp

    from clip_embeds.cli import embed
    from clip_embeds.core.factory import create_model
    from clip_embeds.image.loader import native_decode_preprocess
    from clip_embeds.models.clip import CLIP

    root = ctx["tmp"]
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    paths = write_pngs(img_dir, N_IMAGES)
    blobs = []
    for p in paths:
        with open(p, "rb") as fh:
            blobs.append(fh.read())
    model, params = create_model(MODEL, dtype=jnp.float32,
                                 attn_impl="reference")
    size = model.cfg.vision.image_size
    decoded = native_decode_preprocess(blobs, size)
    check(decoded is not None, "native library unavailable")
    pixels, ok = decoded
    check(bool(ok.all()), f"native decode refused {int((~ok).sum())} PNGs")

    out = os.path.join(root, "image_emb.npy")
    t0 = time.perf_counter()
    rec = run_cli(embed.main, ["--model", MODEL, "--input", img_dir,
                               "--output", out, "--batch-size", str(BATCH)])
    wall = time.perf_counter() - t0
    embs = np.load(out)
    with open(out + ".paths.json") as fh:
        kept = json.load(fh)
    check(kept == paths, f"CLI embedded {len(kept)} of {len(paths)} images")
    check(embs.shape == (N_IMAGES, model.cfg.embed_dim)
          and bool(np.isfinite(embs).all()),
          f"image embeddings {embs.shape} not finite or wrong shape")

    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, x: model.apply(
            {"params": p}, x, normalize=True, method="encode_image"))(
                params, jnp.asarray(pixels[:ROWS_CHECKED]))
    cos = row_cosine(embs[:ROWS_CHECKED], want)
    check(float(cos.min()) >= COS_MIN,
          f"image rows cosine {cos.min():.6f} < {COS_MIN} vs fp32 reference")

    bf16 = CLIP(model.cfg, dtype=jnp.bfloat16)
    dev_params = jax.device_put(params)
    batch = jnp.asarray(pixels[:BATCH], jnp.bfloat16)
    tower = jax.jit(lambda p, x: bf16.apply(
        {"params": p}, x, normalize=True, method="encode_image"))
    sec = seconds_per_call(tower, dev_params, batch)
    ctx.update(model=model, params=dev_params, pixels=pixels, bf16_embs=embs,
               img_dir=img_dir, bf16_tower_img_s=BATCH / sec)
    return {"images": len(kept), "min_row_cos_vs_fp32": float(cos.min()),
            "cli_img_per_s_incl_compile": rec["images_per_sec"],
            "cli_wall_s": round(wall, 2),
            "tower_bf16_img_per_s_b256": round(BATCH / sec, 2),
            "card": gpu}


def phase_text(ctx, gpu):
    import jax
    import jax.numpy as jnp

    from clip_embeds.cli import embed
    from clip_embeds.models.clip import CLIP
    from clip_embeds.text.tokenizer import get_tokenizer

    model, params = ctx["model"], ctx["params"]
    texts = captions(N_TEXTS)
    src = os.path.join(ctx["tmp"], "captions.txt")
    with open(src, "w") as fh:
        fh.write("\n".join(texts) + "\n")
    out = os.path.join(ctx["tmp"], "text_emb.npy")
    rec = run_cli(embed.main, ["--model", MODEL, "--input-texts", src,
                               "--output", out, "--batch-size", str(BATCH)])
    embs = np.load(out)
    check(embs.shape == (N_TEXTS, model.cfg.embed_dim)
          and bool(np.isfinite(embs).all()),
          f"text embeddings {embs.shape} not finite or wrong shape")
    ids = jnp.asarray(get_tokenizer(model.cfg.text.context_length)(texts))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, t: model.apply(
            {"params": p}, t, normalize=True, method="encode_text"))(
                params, ids[:ROWS_CHECKED])
    cos = row_cosine(embs[:ROWS_CHECKED], want)
    check(float(cos.min()) >= COS_MIN,
          f"text rows cosine {cos.min():.6f} < {COS_MIN} vs fp32 reference")
    bf16 = CLIP(model.cfg, dtype=jnp.bfloat16)
    tower = jax.jit(lambda p, t: bf16.apply(
        {"params": p}, t, normalize=True, method="encode_text"))
    sec = seconds_per_call(tower, params, ids[:BATCH])
    return {"texts": N_TEXTS, "min_row_cos_vs_fp32": float(cos.min()),
            "cli_texts_per_s_incl_compile": rec["texts_per_sec"],
            "tower_bf16_texts_per_s_b256": round(BATCH / sec, 2),
            "card": gpu}


def phase_int8(ctx, gpu):
    import jax
    import jax.numpy as jnp

    from clip_embeds.cli import embed

    model, params = ctx["model"], ctx["params"]
    out = os.path.join(ctx["tmp"], "image_emb_int8.npy")
    rec = run_cli(embed.main, ["--model", MODEL, "--input", ctx["img_dir"],
                               "--output", out, "--batch-size", str(BATCH),
                               "--int8"])
    embs = np.load(out)
    check(embs.shape == ctx["bf16_embs"].shape
          and bool(np.isfinite(embs).all()),
          f"int8 embeddings {embs.shape} not finite or wrong shape")
    cos = row_cosine(embs, ctx["bf16_embs"])
    check(float(cos.mean()) >= INT8_COS_MIN,
          f"int8 mean row cosine {cos.mean():.5f} < {INT8_COS_MIN} vs bf16")

    qmodel, qparams = embed.int8_static_model(
        model, params, jnp.asarray(ctx["pixels"][:16]), jnp.bfloat16)
    qparams = jax.device_put(qparams)
    tower = jax.jit(lambda p, x: qmodel.apply(
        {"params": p}, x, normalize=True, method="encode_image"))
    batch = jnp.asarray(ctx["pixels"][:BATCH], jnp.bfloat16)
    sec = seconds_per_call(tower, qparams, batch)
    hlo = tower.lower(qparams, batch).compile().as_text()
    int8_gemms = sum(1 for line in hlo.splitlines()
                     if "__cublas$gemm" in line and "s8[" in line)
    return {"mean_row_cos_vs_bf16": float(cos.mean()),
            "min_row_cos_vs_bf16": float(cos.min()),
            "cli_img_per_s_incl_compile": rec["images_per_sec"],
            "tower_int8_img_per_s_b256": round(BATCH / sec, 2),
            "tower_bf16_img_per_s_b256": round(ctx["bf16_tower_img_s"], 2),
            "cublas_gemm_calls_with_s8_operands": int8_gemms,
            "card": gpu}


class _TrainLog(logging.Handler):
    """Collects cli.train's step log, which it writes after each step's loss
    has reached the host, and JAX's "Compiling jit(train_step)" records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.steps = []
        self.compiles = 0

    def emit(self, record):
        if str(record.msg).startswith("epoch %d step %d loss"):
            self.steps.append((int(record.args[1]), float(record.args[2]),
                               record.created))
        elif record.getMessage().startswith("Compiling jit(train_step)"):
            self.compiles += 1


def run_train_cli(model_name, batch, steps, gpu):
    """A few steps of clip_embeds.cli.train on every visible device: each
    step logged, the loss finite, and the step compiled once."""
    import jax

    from clip_embeds.cli import train

    log = _TrainLog()
    root = logging.getLogger()
    # under jax_log_compiles JAX logs every trace and compilation at
    # WARNING; keep those off the console and count the compilations here
    compile_log = logging.getLogger("jax._src.interpreters.pxla")
    timing_log = logging.getLogger("jax._src.dispatch")
    timing_level = timing_log.level
    root.addHandler(log)
    compile_log.addHandler(log)
    compile_log.propagate = False
    timing_log.setLevel(logging.ERROR)
    root.setLevel(logging.INFO)
    t0 = time.time()
    try:
        with jax.log_compiles(True):
            train.main(["--model", model_name, "--dataset-type", "synthetic",
                        "--batch-size", str(batch),
                        "--train-num-samples", str(batch * steps),
                        "--save-frequency", "0", "--log-every", "1",
                        "--warmup", "1", "--lr", "1e-5"])
    finally:
        root.removeHandler(log)
        compile_log.removeHandler(log)
        compile_log.propagate = True
        timing_log.setLevel(timing_level)
    check(len(log.steps) == steps,
          f"train logged {len(log.steps)} of {steps} steps")
    losses = [loss for _, loss, _ in log.steps]
    check(bool(np.isfinite(losses).all()), f"train loss not finite: {losses}")
    check(log.compiles == 1,
          f"train step compiled {log.compiles} times in {steps} steps")
    done = [t for _, _, t in log.steps]
    step_s = np.diff(done)
    return {"devices": len(jax.devices()), "global_batch": batch,
            "losses": [round(x, 5) for x in losses],
            "train_step_compiles": log.compiles,
            "setup_and_first_step_s": round(done[0] - t0, 2),
            "later_steps_s": [round(float(x), 4) for x in step_s],
            "steady_step_s": round(float(np.median(step_s)), 4),
            "steady_samples_per_s": round(batch / float(np.median(step_s)), 2),
            "card": gpu}


def phase_train(ctx, gpu):
    return run_train_cli(MODEL, TRAIN_BATCH, TRAIN_STEPS, gpu)


def toy_tokenize(text):
    """Deterministic word ids with BOS=1 (no tokenizer files needed)."""
    return [1] + [2 + (sum(map(ord, w)) % 31000) for w in text.split()]


def llava_config():
    """LLaVA-1.5-7B widths (4096 hidden, 32 heads of 128, vocab 32000), the
    trunk cut to 2 of its 32 layers, the ViT-L/14-336 tower whole."""
    import dataclasses

    from clip_embeds.models.llama import LlamaConfig
    from clip_embeds.models.llava import LlavaConfig

    return LlavaConfig(llama=dataclasses.replace(LlamaConfig(), num_layers=2))


def phase_vqascore(ctx, gpu):
    import jax
    import jax.numpy as jnp

    from clip_embeds.models.llava import IMAGE_TOKEN_INDEX, Llava
    from clip_embeds.scores.vqa_score import VQAScorer

    cfg = llava_config()
    model = Llava(cfg, dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    params = jax.jit(model.init)(
        jax.random.PRNGKey(0),
        jnp.asarray([[1, IMAGE_TOKEN_INDEX, 5, 6]], jnp.int32),
        jnp.zeros((1, size, size, 3), jnp.float32))["params"]
    scorer = VQAScorer(model, params, toy_tokenize, bos_token_id=1,
                       pad_token_id=0, batch_size=8)
    images = [synthetic_image(rng, 400, 300), synthetic_image(rng, 280, 360)]
    texts = ["a red car parked next to a tree",
             "two dogs running on the beach",
             "a person riding a bicycle down the street",
             "a small cat sitting under a table"]

    def pairs():
        return scorer.forward([im for im in images for _ in texts],
                              texts * len(images)).reshape(len(images), -1)

    def prefix():
        return np.stack([scorer.forward_image_texts(im, texts)
                         for im in images])

    want, got = pairs(), prefix()   # compiles
    t0 = time.perf_counter()
    want = pairs()
    t_pairs = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = prefix()
    t_prefix = time.perf_counter() - t0
    check(bool(np.isfinite(want).all() and np.isfinite(got).all()),
          "VQAScore not finite")
    # random weights put P("Yes") near 1/vocab (~3e-5), where an absolute
    # limit on the score cannot fail; the log score carries the check
    diff = float(np.abs(got - want).max())
    log_diff = float(np.abs(np.log(got) - np.log(want)).max())
    check(diff <= VQA_TOL and log_diff <= VQA_LOG_TOL,
          f"VQAScore prefix vs per-pair |d| {diff:.3g} (limit {VQA_TOL}), "
          f"|d log| {log_diff:.3g} (limit {VQA_LOG_TOL})")
    n = want.size
    return {"m_x_n": list(want.shape), "max_abs_score_diff": diff,
            "max_abs_log_score_diff": log_diff,
            "mean_score": float(want.mean()),
            "per_pair_scores_per_s": round(n / t_pairs, 2),
            "kv_prefix_scores_per_s": round(n / t_prefix, 2), "card": gpu}


def _adam_mu(opt_state):
    """The first moments of the AdamW state. After one step from zero they
    are (1 - beta1) times the gradient the step applied."""
    import jax

    return [leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(opt_state)[0]
            if any(getattr(k, "name", None) == "mu" for k in path)]


def phase_multi(ctx, gpu, model_name=MODEL, per_device=16,
                train_steps=TRAIN_STEPS):
    """The training entry point's step on the dp=4 mesh against one card,
    cli.train on four devices, and the SigLIP ring against one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from clip_embeds.cli import train
    from clip_embeds.core.factory import create_model
    from clip_embeds.data.synthetic import synthetic_batches
    from clip_embeds.losses.siglip import siglip_loss, siglip_loss_ring
    from clip_embeds.parallel.mesh import (
        batch_sharding,
        create_mesh,
        replicated_sharding,
    )
    from clip_embeds.train.optim import adamw
    from clip_embeds.train.steps import TrainState, make_clip_train_step

    devices = jax.devices()
    n = len(devices)
    check(n == 4, f"--multi needs 4 devices, found {n}")
    mesh = create_mesh(n, 1, devices=devices)
    model, params = create_model(model_name, dtype=jnp.bfloat16)
    cfg = model.cfg
    batch = next(synthetic_batches(
        batch_size=per_device * n, image_size=cfg.vision.image_size,
        context_length=cfg.text.context_length, num_batches=1))

    # one step of the step function cli.train jits, with its AdamW defaults,
    # from the same host state: committed to one card, and replicated over
    # the mesh as cli.train commits it
    a = train.parse_args(["--model", model_name])
    tx = adamw(a.lr, a.beta1, a.beta2, a.eps, a.wd,
               max_grad_norm=a.grad_clip_norm)
    state = jax.device_get(TrainState.create(params, tx))
    del params
    step = jax.jit(make_clip_train_step(model))
    one = devices[0]
    new1, m1 = step(jax.device_put(state, one), jax.device_put(batch, one))
    s4 = jax.device_put(state, replicated_sharding(mesh))
    b4 = jax.device_put(batch, batch_sharding(mesh))
    with jax.sharding.set_mesh(mesh):
        new4, m4 = step(s4, b4)
        hlo = step.lower(s4, b4).compile().as_text()
    rel = abs(float(m4["loss"]) - float(m1["loss"])) / abs(float(m1["loss"]))
    # the gradient each step applied, and the updated params: every replica
    # holds the same values, and their update points the way the one-card
    # update does (float64 dot products, leaf by leaf)
    mu1, mu4 = _adam_mu(new1.opt_state), _adam_mu(new4.opt_state)
    check(len(mu1) == len(jax.tree.leaves(state.params)),
          "no AdamW first moments")
    dots = np.zeros((2, 3))   # [gradient, update] x [<4,1>, <4,4>, <1,1>]
    spread = 0.0
    for p0, p1, p4, g1, g4 in zip(
            jax.tree.leaves(state.params), jax.tree.leaves(new1.params),
            jax.tree.leaves(new4.params), mu1, mu4):
        shards = [np.asarray(sh.data, np.float64).ravel()
                  for sh in p4.addressable_shards]
        spread = max([spread] + [float(np.abs(x - shards[0]).max())
                                 for x in shards])
        p0 = np.asarray(p0, np.float64).ravel()
        for row, (x, y) in enumerate((
                (np.asarray(g4, np.float64).ravel(),
                 np.asarray(g1, np.float64).ravel()),
                (shards[0] - p0, np.asarray(p1, np.float64).ravel() - p0))):
            dots[row] += (x @ y, x @ x, y @ y)
    gcos, ucos = (dots[:, 0] / np.sqrt(dots[:, 1] * dots[:, 2])).tolist()
    gnorm = float(np.sqrt(dots[0, 1] / dots[0, 2]))
    check(rel <= MULTI_LOSS_RTOL and gcos >= MULTI_GRAD_COS
          and abs(gnorm - 1) <= MULTI_GRAD_NORM_RTOL,
          f"dp={n} train step: loss rel {rel:.3g}, gradient cosine "
          f"{gcos:.6f}, gradient norm ratio {gnorm:.6f}")
    check(spread == 0.0, f"dp={n} replicas differ by up to {spread:.3g}")
    check(ucos >= MULTI_UPDATE_COS,
          f"dp={n} param update cosine {ucos:.6f} < {MULTI_UPDATE_COS}")
    collectives = sorted({op for op in ("all-gather", "all-reduce",
                                        "reduce-scatter") if op in hlo})
    del new1, new4, s4, mu1, mu4

    def seconds_per_step(st, b, iters=3):
        """Median over 3 windows of `iters` steps, each step fed the state
        the last one returned; the first step is not timed."""
        st, m = step(st, b)
        jax.block_until_ready(m)
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                st, m = step(st, b)
            jax.block_until_ready(m)
            windows.append((time.perf_counter() - t0) / iters)
        return float(np.median(windows))

    with jax.sharding.set_mesh(mesh):
        sec4 = seconds_per_step(
            jax.device_put(state, replicated_sharding(mesh)), b4)
    sec1 = seconds_per_step(jax.device_put(state, one),
                            jax.device_put(batch, one))
    del state, b4

    # the training CLI itself on the four devices
    cli = run_train_cli(model_name, per_device * n, train_steps, gpu)

    # SigLIP ring: text features stream around the 4 devices (ppermute)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    gb, dim = 256 * n, cfg.embed_dim
    unit = lambda x: x / jnp.linalg.norm(x, axis=-1, keepdims=True)  # noqa: E731
    img = unit(jax.random.normal(keys[0], (gb, dim))).astype(jnp.bfloat16)
    txt = unit(jax.random.normal(keys[1], (gb, dim))).astype(jnp.bfloat16)
    scale, bias = jnp.asarray(10.0), jnp.asarray(-10.0)
    ring = jax.jit(jax.value_and_grad(
        lambda t, i: siglip_loss_ring(i, t, scale, bias, mesh)))
    glob = jax.jit(jax.value_and_grad(
        lambda t, i: siglip_loss(i, t, scale, bias)))
    shard = NamedSharding(mesh, P("data"))
    sl4, sg4 = ring(jax.device_put(txt, shard), jax.device_put(img, shard))
    sl1, sg1 = glob(jax.device_put(txt, one), jax.device_put(img, one))
    srel = abs(float(sl4) - float(sl1)) / abs(float(sl1))
    scos = cosine(flat64(sg4), flat64(sg1))
    check(srel <= MULTI_LOSS_RTOL and scos >= MULTI_GRAD_COS,
          f"siglip ring loss rel {srel:.3g} grad cosine {scos:.6f}")
    return {"train_step": {
                "global_batch": per_device * n,
                "loss_rel_diff": rel, "grad_cosine": gcos,
                "grad_norm_ratio": gnorm, "replica_max_abs_diff": spread,
                "update_cosine": ucos, "collectives": collectives,
                "step_s_dp4": round(sec4, 4),
                "step_s_one_card": round(sec1, 4)},
            "cli_train": cli,
            "siglip_ring_loss_rel_diff": srel, "siglip_ring_grad_cosine": scos,
            "card": gpu}


SINGLE = [("attention", phase_attention), ("image", phase_image),
          ("text", phase_text), ("int8", phase_int8), ("train", phase_train),
          ("vqascore", phase_vqascore)]
MULTI = [("multi", phase_multi)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: the data-parallel phases only")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"device: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from clip_embeds.core.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    gpu = card().splitlines()[0]
    print(f"device: {dev.device_kind} x{len(jax.devices())} ({gpu})",
          flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        ctx = {"tmp": tmp}
        for name, phase in (MULTI if args.multi else SINGLE):
            t0 = time.perf_counter()
            try:
                rec = phase(ctx, gpu)
                status = "ok"
            except Exception as exc:  # report every phase, then fail
                traceback.print_exc()
                rec = {"error": f"{type(exc).__name__}: {exc}"[:2000]}
                status = "FAILED"
                failed.append(name)
            rec["phase_s"] = round(time.perf_counter() - t0, 1)
            print(f"{name}: {status} {json.dumps(rec)}", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
