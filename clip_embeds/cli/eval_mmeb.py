"""MMEB embedding-retrieval evaluation driver.

JAX equivalent of the reference entry point ``VLM2Vec/eval.py``
(eval.py:31-180): per subset, encode the deduplicated query and target sides
with the VLM bi-encoder (last-token pooling), cache the embeddings under
``--encode_output_path``, score each query against its candidate targets
(gold first: prediction 0 is correct), and report per-subset + average
accuracy. Arguments are the reference's dataclasses (train/arguments.py),
parsed with the HfArgumentParser-equivalent.

Zero-egress data layout: ``--dataset_name`` is a directory holding one
``<subset>.json[l]`` per ``--subset_name``, rows shaped
{"qry_text", "qry_img_path", "tgt_text": [...], "tgt_img_path": [...]}
(the reference's TIGER-Lab/MMEB-eval schema; image paths relative to
``--image_dir``).

Checkpoints: ``--model_name`` is a converted score bundle
(config.json + params.npz [+ tokenizer/]); ``--checkpoint_path`` may point
at a trained adapter npz from cli/train_vlm2vec.py — it is merged into the
base before eval (models/lora.merge_lora == peft merge_and_unload,
reference model.py:194-203). Omitting the bundle runs a tiny random-init
model (smoke).

Usage:
  python -m clip_embeds.cli.eval_mmeb \
      --model_name /bundles/llava-v1.5-7b \
      --checkpoint_path /ckpt/vlm2vec/adapter-final.npz --lora \
      --dataset_name /data/mmeb-eval --subset_name ImageNet-1K OK-VQA \
      --image_dir /data/mmeb-eval/images \
      --encode_output_path /tmp/mmeb-embeds
"""

from __future__ import annotations

import json
import logging
import os


def _load_subset_rows(path: str):
    if path.endswith(".jsonl"):
        with open(path) as fh:
            return [json.loads(line) for line in fh if line.strip()]
    with open(path) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("eval_mmeb")

    from ..train.arguments import (
        DataArguments,
        ModelArguments,
        TrainingArguments,
        parse_dataclasses,
    )

    model_args, data_args, training_args = parse_dataclasses(
        [ModelArguments, DataArguments, TrainingArguments], argv
    )

    import jax.numpy as jnp
    import numpy as np

    import jax

    from ..core.compile_cache import enable_persistent_cache

    enable_persistent_cache()

    from ..evals.mmeb import evaluate_subset, make_embedding_encoders
    from ..models.llava import Llava, LlavaConfig, llava_tiny_config
    from ..scores.build import config_from_dict, load_score_bundle
    from ..scores.embedding_scorer import EmbeddingScorer
    from ..scores.vqa_score import hf_tokenizer_adapter
    from .train_vlm2vec import _toy_tokenize

    dtype = jnp.bfloat16 if training_args.bf16 else jnp.float32
    tokenize, bos_id, pad_id = _toy_tokenize, 1, 0
    bundle = model_args.model_name
    if bundle and os.path.isdir(bundle):
        meta, params = load_score_bundle(bundle)
        cfg = config_from_dict(LlavaConfig, meta.get("model", {}))
        tok_dir = os.path.join(bundle, "tokenizer")
        if os.path.isdir(tok_dir):
            from transformers import AutoTokenizer

            tokenize, bos_id, pad_id = hf_tokenizer_adapter(
                AutoTokenizer.from_pretrained(tok_dir)
            )
        else:
            log.warning(
                "bundle %s has NO tokenizer/ subdir — falling back to the "
                "toy hashed tokenizer; real-checkpoint eval with it "
                "produces garbage", bundle)
    else:
        log.info("no --model_name bundle: tiny random-init model (smoke)")
        cfg = llava_tiny_config()
        params = None
    model = Llava(cfg, dtype=dtype)
    if params is None:
        params = model.init(
            jax.random.PRNGKey(0), np.zeros((1, 8), np.int32),
            np.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3),
                     np.float32),
        )["params"]

    if model_args.quant_base:
        # mirror of train_vlm2vec --quant_base: W8A8 trunk, adapters (if
        # any) served unmaterialized — int8 kernels cannot absorb merged
        # fp deltas
        from ..models.quant import quantize_llava_trunk

        params = quantize_llava_trunk(jax.device_get(params))
        model = Llava(cfg, dtype=dtype, quant_llm="dynamic",
                      lora_rank=model_args.lora_r,
                      lora_alpha=float(model_args.lora_alpha))
        log.info("--quant_base: W8A8 trunk")

    adapter = model_args.checkpoint_path
    lora_tree = None
    if adapter and adapter.endswith(".npz"):
        # normalize_lora accepts the trainer's npz-flat layout directly;
        # unmatched keys in a merge are a hard error, not a silent
        # zero-delta merge.
        lora = dict(np.load(adapter))
        if model_args.quant_base:
            lora_tree = lora
            log.info("serving LoRA adapter %s unmaterialized (alpha %d)",
                     adapter, model_args.lora_alpha)
        else:
            from ..models.lora import merge_lora

            params = merge_lora(params, lora,
                                alpha=float(model_args.lora_alpha))
            log.info("merged LoRA adapter %s (alpha %d)",
                     adapter, model_args.lora_alpha)

    scorer = EmbeddingScorer(
        model, params, tokenize, bos_token_id=bos_id, pad_token_id=pad_id,
        batch_size=training_args.per_device_train_batch_size,
        max_len=data_args.max_len, lora=lora_tree,
    )
    encode_queries, encode_targets = make_embedding_encoders(scorer)

    root = data_args.dataset_name
    image_dir = data_args.image_dir or ""
    cache_dir = data_args.encode_output_path
    results = {}
    for sub in data_args.subset_name or []:
        for ext in (".json", ".jsonl"):
            path = os.path.join(root, sub + ext)
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(f"no {sub}.json[l] under {root}")
        rows = _load_subset_rows(path)

        def join(p):
            return os.path.join(image_dir, p) if p else ""

        rows = [
            {
                "qry_text": r["qry_text"],
                "qry_img_path": join(r.get("qry_img_path", "")),
                "tgt_text": list(r["tgt_text"]),
                "tgt_img_path": [join(p) for p in r.get(
                    "tgt_img_path", [""] * len(r["tgt_text"]))],
            }
            for r in rows
        ]
        res = evaluate_subset(
            rows, encode_queries, encode_targets,
            cache_dir=cache_dir, subset=sub,
        )
        results[sub] = res
        log.info("%s: acc %.4f (%d/%d)", sub, res["acc"],
                 res["num_correct"], res["num_pred"])

    if results:
        avg = sum(r["acc"] for r in results.values()) / len(results)
        log.info("average accuracy over %d subsets: %.4f", len(results), avg)
        if cache_dir:
            with open(os.path.join(cache_dir, "results.json"), "w") as fh:
                json.dump({"subsets": results, "average": avg}, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
