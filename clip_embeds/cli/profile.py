"""FLOP/activation profiler CLI (reference open_clip_train/profiler.py).

Uses XLA cost analysis of the jitted forward instead of fvcore /
FlopCounterMode; emits the same CSV columns (model, image_size, image_width,
text_width, embed_dim, gflops, mparams) per profiled model.

  python -m clip_embeds.cli.profile --model ViT-B-32 ViT-L-14-336
"""

from __future__ import annotations

import argparse
import csv
import sys


def count_params(params) -> int:
    import jax

    return sum(x.size for x in jax.tree.leaves(params))


def profile_model(name: str):
    import jax
    import jax.numpy as jnp

    from ..core.factory import create_model

    model, params = create_model(name)
    cfg = model.cfg
    images = jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3))
    texts = jnp.zeros((1, cfg.text.context_length), jnp.int32)

    def forward(p, images, texts):
        return model.apply({"params": p}, images, texts)

    lowered = jax.jit(forward).lower(params, images, texts)
    cost = lowered.compile().cost_analysis()
    flops = cost.get("flops", 0.0) if cost else 0.0

    def tower_flops(method, *args):
        lo = jax.jit(
            lambda p, *a: model.apply({"params": p}, *a, method=method)
        ).lower(params, *args)
        c = lo.compile().cost_analysis()
        return c.get("flops", 0.0) if c else 0.0

    return {
        "model": name,
        "image_size": cfg.vision.image_size,
        "image_width": cfg.vision.width,
        "text_width": cfg.text.width,
        "embed_dim": cfg.embed_dim,
        "mparams": round(count_params(params) / 1e6, 2),
        "gflops": round(flops / 1e9, 2),
        "image_gflops": round(tower_flops("encode_image", images) / 1e9, 2),
        "text_gflops": round(tower_flops("encode_text", texts) / 1e9, 2),
    }


def capture_trace(name: str, trace_dir: str, batch_size: int = 8,
                  steps: int = 3) -> str:
    """Capture a runtime profiler trace of the jitted forward.

    Rounds out the cost-analysis CSV with an actual timeline (the reference's
    profiler.py is FLOP-count-only; runtime timing lives in its train-loop
    meters). Output is a TensorBoard-compatible trace directory
    (xplane.pb + trace.json.gz) viewable with `tensorboard --logdir` or
    Perfetto."""
    import jax
    import jax.numpy as jnp

    from ..core.factory import create_model

    model, params = create_model(name)
    cfg = model.cfg
    params = jax.device_put(params)
    images = jnp.zeros(
        (batch_size, cfg.vision.image_size, cfg.vision.image_size, 3))
    texts = jnp.zeros((batch_size, cfg.text.context_length), jnp.int32)

    @jax.jit
    def forward(p, images, texts):
        return model.apply({"params": p}, images, texts)

    # compile + warm OUTSIDE the trace so the capture shows steady-state steps
    jax.block_until_ready(forward(params, images, texts))
    with jax.profiler.trace(trace_dir):
        for _ in range(steps):
            out = forward(params, images, texts)
        jax.block_until_ready(out)
    return trace_dir


def main(argv=None):
    p = argparse.ArgumentParser("clip_embeds profiler")
    p.add_argument("--model", nargs="+", default=["ViT-B-32"])
    p.add_argument("--results-file", default=None)
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="also capture a jax.profiler runtime trace of each "
                        "model's forward into DIR/<model>")
    p.add_argument("--trace-batch-size", type=int, default=8)
    args = p.parse_args(argv)

    rows = [profile_model(name) for name in args.model]
    if args.trace:
        import os

        for name in args.model:
            out_dir = os.path.join(args.trace, name.replace("/", "-"))
            capture_trace(name, out_dir, batch_size=args.trace_batch_size)
            print(f"trace for {name}: {out_dir}", file=sys.stderr)
    out = open(args.results_file, "w") if args.results_file else sys.stdout
    writer = csv.DictWriter(out, fieldnames=list(rows[0]))
    writer.writeheader()
    writer.writerows(rows)
    if args.results_file:
        out.close()
    return rows


if __name__ == "__main__":
    main()
