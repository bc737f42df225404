"""t2v_metrics-style benchmark loop: one score model x many datasets.

Reference: t2v_metrics/eval.py:22-52 — builds a score model by name and
loops `dataset -> batch_forward -> evaluate_scores` over the VQAScore-paper
datasets. Here the score model resolves through the native stack:

  * any registry CLIP arch (e.g. ViT-L-14-336, convnext_base_w) -> CLIPScore
  * 'siglip:<arch>' -> SigLIP sigmoid pairing (--siglip-tokenizer points at
    a local sentencepiece .model; runs the native unigram engine)
  * any registered VQAScore/ITM name (llava-v1.5-7b, clip-flant5-xxl,
    blip2-itm, ...) with --checkpoint <score bundle> -> live scorer via
    scores.registry.get_score_model

Usage:
  python -m clip_embeds.cli.t2v_eval --model ViT-L-14-336 \
      --pretrained /ckpt.pt --root_dir /data/t2v \
      --datasets winoground sugarcrepe eqben_mini
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

DEFAULT_DATASETS = [
    # the reference eval.py main loop (eval.py:38-49)
    "winoground", "naturalbench_retrieval", "eqben_mini", "seetrue",
    "sugarcrepe", "cococounterfactuals",
]


def build_score(args):
    import jax.numpy as jnp

    from ..core.factory import create_model
    from ..scores.registry import list_all_models
    from ..scores.score import CLIPScore, Score

    dtype = jnp.bfloat16 if args.precision == "bf16" else jnp.float32
    if args.model.startswith("siglip:"):
        from ..core.openclip_registry import resolve_siglip_config
        from ..models.siglip import Siglip, convert_siglip_state_dict
        from ..scores.scorers import SiglipScorer
        from ..text.tokenizer import SigLipTokenizer

        if not args.siglip_tokenizer:
            raise SystemExit(
                "siglip scoring needs --siglip-tokenizer "
                "<local sentencepiece .model file>"
            )
        arch = args.model.split(":", 1)[1]
        cfg = resolve_siglip_config(arch)
        smodel = Siglip(cfg, dtype=dtype)
        if args.pretrained:
            import torch

            params = convert_siglip_state_dict(torch.load(
                args.pretrained, map_location="cpu", weights_only=True))
        else:
            import jax

            params = smodel.init(
                jax.random.PRNGKey(0),
                jnp.zeros((1, cfg.vision.image_size,
                           cfg.vision.image_size, 3)),
                jnp.zeros((1, 64), jnp.int32),
            )["params"]
        tok = SigLipTokenizer(args.siglip_tokenizer)
        scorer = SiglipScorer(smodel, params, tok,
                              batch_size=args.batch_size)
        return Score(lambda images, texts: scorer.sigmoid_scores(
            images, texts).diagonal())
    if args.checkpoint or (":" not in args.model
                           and args.model in list_all_models()):
        from ..scores.registry import get_score_model

        return get_score_model(args.model, checkpoint=args.checkpoint,
                               batch_size=args.batch_size)
    model, params = create_model(args.model, args.pretrained, dtype=dtype)
    return CLIPScore(model, params, batch_size=args.batch_size)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root_dir", default="./datasets")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="score bundle dir for VQAScore/ITM names")
    p.add_argument("--siglip-tokenizer", default=None,
                   help="local sentencepiece .model for siglip:<arch>")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--datasets", nargs="+", default=DEFAULT_DATASETS)
    p.add_argument("--output", default=None,
                   help="optional results .json path")
    args = p.parse_args(argv)

    from ..evals.benchmarks import get_benchmark, run_benchmark

    score = build_score(args)
    results = {}
    for name in args.datasets:
        try:
            dataset = get_benchmark(name, args.root_dir)
        except FileNotFoundError as e:
            print(f"{name}: data missing ({e}); skipping", file=sys.stderr)
            continue
        _, metrics = run_benchmark(score, dataset,
                                   batch_size=args.batch_size)
        results[name] = metrics
        print(name, json.dumps(metrics))
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(results, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
