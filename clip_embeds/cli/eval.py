"""Evaluation CLI: one dispatcher for the reference's per-family drivers.

Covers `python eval_clip.py --dataset=a --root-dir=...`
(Patch-Aligned-Contrastive-Learning/eval_{clip,pacl,sparc}.py:367-401 and
VLM2Vec/eval_llava15.py) with --scorer selecting the model family.

  python -m clip_embeds.cli.eval --scorer clip --model ViT-L-14-336 \
      --pretrained /path/ckpt.pt --dataset a --root-dir /data/whatsup
"""

from __future__ import annotations

import argparse
import json
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds eval")
    p.add_argument("--scorer", default="clip",
                   choices=["clip", "siglip", "pacl", "sparc", "embedding"])
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--model-path", default=None,
                   help="PACL/SPARC head checkpoint (.npz) or LLaVA params")
    p.add_argument("--dataset", default="a",
                   choices=["a", "b", "a4", "b4", "cocoone", "cocotwo",
                            "vgone", "vgtwo", "mmvp", "mmvpvlm"])
    p.add_argument("--root-dir", required=True)
    p.add_argument("--results-file", default="evaluation_results.txt")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--rope", default="none", choices=["none", "before", "after"])
    p.add_argument("--sparc-local", action="store_true")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    return p.parse_args(argv)


def build_scorer(args):
    import jax.numpy as jnp

    from ..core.factory import create_model, load_params
    from ..scores.scorers import CLIPScorer, PACLScorer, SPARCScorer

    dtype = jnp.bfloat16 if args.precision == "bf16" else jnp.float32
    if args.scorer == "siglip":
        # SigLIP family resolves through the data registry, not MODEL_CONFIGS
        import jax

        from ..core.openclip_registry import resolve_siglip_config
        from ..models.siglip import Siglip, convert_siglip_state_dict
        from ..scores.scorers import SiglipScorer

        cfg = resolve_siglip_config(args.model)
        smodel = Siglip(cfg, dtype=dtype)
        if args.pretrained:
            import torch

            sparams = convert_siglip_state_dict(
                torch.load(args.pretrained, map_location="cpu",
                           weights_only=True)
            )
        else:
            sparams = smodel.init(
                jax.random.PRNGKey(0),
                jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size,
                           3)),
                jnp.zeros((1, cfg.text.max_position_embeddings), jnp.int32),
            )["params"]
        try:
            from ..text.tokenizer import SigLipTokenizer

            tokenize = SigLipTokenizer()
        except Exception:
            raise SystemExit(
                "SigLIP tokenizer needs sentencepiece; pass texts through "
                "scores.scorers.SiglipScorer with an injected tokenizer"
            )
        return SiglipScorer(smodel, sparams, tokenize,
                            batch_size=args.batch_size)
    model, params = create_model(args.model, args.pretrained, dtype=dtype)
    if args.scorer == "clip":
        return CLIPScorer(model, params, batch_size=args.batch_size)

    import jax

    from ..models.heads import PACLHead, SPARCHead

    if args.scorer == "pacl":
        head = PACLHead(proj_dim=model.cfg.embed_dim, rope=args.rope)
        patches = jnp.zeros(
            (1, model.cfg.vision.num_patches, model.cfg.vision.width)
        )
        text_emb = jnp.zeros((1, model.cfg.embed_dim))
        head_params = (
            load_params(args.model_path)
            if args.model_path
            else head.init(jax.random.PRNGKey(0), patches, text_emb)["params"]
        )
        return PACLScorer(model, params, head, head_params,
                          batch_size=args.batch_size)
    if args.scorer == "sparc":
        head = SPARCHead(proj_dim=model.cfg.embed_dim, rope=args.rope != "none")
        patches = jnp.zeros(
            (1, model.cfg.vision.num_patches, model.cfg.vision.width)
        )
        tokens = jnp.zeros(
            (1, model.cfg.text.context_length, model.cfg.text.width)
        )
        head_params = (
            load_params(args.model_path)
            if args.model_path
            else head.init(jax.random.PRNGKey(0), patches, tokens)["params"]
        )
        return SPARCScorer(model, params, head, head_params,
                           batch_size=args.batch_size, local=args.sparc_local)
    raise NotImplementedError(
        "embedding scorer needs a LLaVA checkpoint + HF tokenizer; "
        "construct scores.embedding_scorer.EmbeddingScorer directly"
    )


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..evals.mmvp import eval_mmvp
    from ..evals.whatsup import eval_coco_vg, eval_whatsup, load_annotation

    scorer = build_scorer(args)
    with open(args.results_file, "a") as f:
        f.write("Model path: {} ".format(args.model_path or args.model))
        f.write("Dataset: {}\n".format(args.dataset))

    if args.dataset in ("mmvp", "mmvpvlm"):
        results = eval_mmvp(
            scorer.pair_score, args.root_dir, args.dataset,
            results_file=args.results_file,
        )
    else:
        dataset, _ = load_annotation(args.root_dir, args.dataset)
        if args.dataset in ("a", "b", "a4", "b4"):
            results = eval_whatsup(
                scorer.score_batch, dataset, args.root_dir,
                four_option=args.dataset.endswith("4"),
                results_file=args.results_file,
            )
        else:
            results = eval_coco_vg(
                scorer.score_batch, dataset, args.root_dir,
                "coco" if args.dataset.startswith("coco") else "vg",
                results_file=args.results_file,
            )
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
