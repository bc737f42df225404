"""Construct live Score models from converted checkpoint bundles.

Reference: t2v_metrics/t2v_metrics/__init__.py:13-20 returns a live scorer
for every registered name by downloading the HF checkpoint. This environment
has no egress, so the equivalent input is a local *score bundle*: a directory

    <bundle>/config.json   {"family": ..., "conversation": ...,
                            "model": {<family config dataclass as dict>}}
    <bundle>/params.npz    flattened params (core.factory.flatten_params)
    <bundle>/tokenizer/    optional HF tokenizer dir (loaded offline)

produced by ``save_score_bundle`` after running the family converter in
core/torch_convert.py on the reference torch checkpoint. ``build_score_model``
(the backend of registry.get_score_model) restores the config, loads params,
and wires the right scorer class:

    LLaVA family  (llava-v1.5-*, sharegpt4v-*, llava-phi-3, llava-llama-3)
                  -> scores.score.VQAScore      (vqa_score.VQAScorer)
    clip-flant5-* -> vqa_score.T5VQAScorer
    instructblip-flant5-* -> vqa_score.InstructBlipVQAScorer
    blip2-itm*    -> scores.score.ITMScore
    image-reward-v1 -> scores.score.ImageRewardScore
    blip2-itc*    -> Q-Former ITC cosine scorer
    gpt-4*        -> GPT4VScorer (requires the injectable ``complete`` transport)
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..models.llama import LlamaConfig
from ..models.llava import LlavaConfig


# -- config (de)serialization -------------------------------------------------


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def _resolve_dataclass(tp):
    """Unwrap Optional[...] and return tp if it is a dataclass, else None."""
    if dataclasses.is_dataclass(tp):
        return tp
    if typing.get_origin(tp) is typing.Union:
        for arg in typing.get_args(tp):
            if dataclasses.is_dataclass(arg):
                return arg
    return None


def config_from_dict(cls, d: Dict[str, Any]):
    """Rebuild a (possibly nested) frozen config dataclass from plain JSON."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _resolve_dataclass(hints.get(f.name))
        if sub is not None and isinstance(v, dict):
            v = config_from_dict(sub, v)
        elif isinstance(v, list):
            v = tuple(
                tuple(e) if isinstance(e, list) else e for e in v
            )
        kwargs[f.name] = v
    return cls(**kwargs)


# -- bundle io ----------------------------------------------------------------


def save_score_bundle(
    path: str,
    family: str,
    model_cfg,
    params: Dict[str, Any],
    conversation: Optional[str] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a score bundle directory (config.json + params.npz)."""
    from ..core.factory import flatten_params

    os.makedirs(path, exist_ok=True)
    meta: Dict[str, Any] = {"family": family,
                            "model": config_to_dict(model_cfg)}
    if conversation is not None:
        meta["conversation"] = conversation
    if extra:
        meta.update(extra)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(os.path.join(path, "params.npz"), **flatten_params(params))


def load_score_bundle(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta dict, params tree) from a bundle dir, or params-only from .npz."""
    from ..core.factory import unflatten_params

    if os.path.isdir(path):
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        flat = dict(np.load(os.path.join(path, "params.npz")))
        return meta, unflatten_params(flat)
    if path.endswith(".npz"):
        return {}, unflatten_params(dict(np.load(path)))
    raise ValueError(f"not a score bundle: {path!r}")


def _bundle_hf_tokenizer(path: str, subdir: str = "tokenizer"):
    tok_dir = os.path.join(path, subdir) if os.path.isdir(path) else None
    if tok_dir and os.path.isdir(tok_dir):
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(tok_dir)
    return None


# -- per-name default configs -------------------------------------------------


def llama_13b_config() -> LlamaConfig:
    return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                       num_layers=40, num_heads=40)


def llama3_8b_config() -> LlamaConfig:
    """Meta-Llama-3-8B-Instruct shape (llava-llama-3 backbone)."""
    return LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8,
        max_position_embeddings=8192, rope_theta=500000.0,
    )


def _llava_cfg(name: str) -> LlavaConfig:
    from ..models.phi3 import phi3_mini_config

    # llava-v1.6-13b scores with image_aspect_ratio='pad' in the reference
    # (llava16_model.py:41,103-106): a single square 336px image through the
    # plain splice path — identical to LLaVA-1.5 at score time, so it shares
    # the Llava backbone with the vicuna-13b trunk.
    if name in ("llava-v1.5-13b", "sharegpt4v-13b", "llava-v1.6-13b"):
        return LlavaConfig(llama=llama_13b_config())
    if name == "llava-phi-3":
        return LlavaConfig(llama=phi3_mini_config())
    if name == "llava-llama-3":
        return LlavaConfig(llama=llama3_8b_config())
    return LlavaConfig()  # 7B default (llava-v1.5-7b, sharegpt4v-7b)


def _flant5_cfg(size: str):
    from ..models.t5 import T5Config

    if size == "xxl":
        return T5Config(d_model=4096, d_ff=10240, num_layers=24,
                        num_heads=64)
    if size == "xl":
        return T5Config(d_model=2048, d_ff=5120, num_layers=24,
                        num_heads=32)
    raise KeyError(size)


def default_model_config(name: str):
    """Registered score-model name -> default (full-size) config dataclass."""
    from ..models.blip import BlipConfig
    from ..models.blip2 import Blip2Config
    from ..models.clip_t5 import CLIPT5Config
    from ..models.instructblip import InstructBlipConfig
    from .registry import (
        BLIP2_ITC_MODELS,
        BLIP2_ITM_MODELS,
        CLIP_T5_MODELS,
        IMAGE_REWARD_MODELS,
        INSTRUCTBLIP_MODELS,
        LLAVA16_MODELS,
        LLAVA_LLAMA_MODELS,
        LLAVA_MODELS,
    )

    if name in LLAVA_MODELS + LLAVA_LLAMA_MODELS + LLAVA16_MODELS:
        return _llava_cfg(name)
    if name in CLIP_T5_MODELS:
        size = "xl" if name == "clip-flant5-xl" else "xxl"
        return CLIPT5Config(t5=_flant5_cfg(size))
    if name in INSTRUCTBLIP_MODELS:
        size = name.rsplit("-", 1)[-1]
        return InstructBlipConfig(t5=_flant5_cfg(size))
    if name in BLIP2_ITM_MODELS + BLIP2_ITC_MODELS:
        from ..core.config import VisionConfig
        from ..models.blip2 import QFormerConfig

        if name.endswith("-vitL"):
            return Blip2Config(
                vision=VisionConfig(image_size=224, patch_size=14,
                                    width=1024, layers=24, head_width=64),
                qformer=QFormerConfig(encoder_hidden_size=1024),
            )
        if name.endswith("-coco"):
            return Blip2Config(
                vision=VisionConfig(image_size=364, patch_size=14,
                                    width=1408, layers=39, head_width=88,
                                    mlp_ratio=6144 / 1408),
            )
        return Blip2Config()
    if name in IMAGE_REWARD_MODELS:
        return BlipConfig()
    raise KeyError(f"no default config for {name!r}")


VQA_CONVERSATIONS = {
    "llava-v1.5-13b": "chat", "llava-v1.5-7b": "chat",
    "sharegpt4v-7b": "chat", "sharegpt4v-13b": "chat",
    "llava-phi-3": "phi3_instruct", "llava-llama-3": "llama3",
    "llava-v1.6-13b": "chat",
    "clip-flant5-xxl": "t5_chat", "clip-flant5-xl": "t5_chat",
    "clip-flant5-xxl-no-system": "t5_chat_no_system",
    "clip-flant5-xxl-no-system-no-user": "t5_chat_no_system_no_user",
}


# -- live construction --------------------------------------------------------


def build_score_model(
    name: str,
    checkpoint: str,
    dtype: Any = None,
    tokenize: Optional[Callable] = None,
    qformer_tokenize: Optional[Callable] = None,
    complete: Optional[Callable] = None,
    **kw,
):
    """Build a live Score for a registered VQA/ITM/ITC name from a bundle.

    ``tokenize`` (and ``qformer_tokenize`` for InstructBLIP) override the
    bundle's own ``tokenizer/`` dir; one of the two sources must exist.
    """
    import jax.numpy as jnp

    from .registry import (
        BLIP2_ITC_MODELS,
        BLIP2_ITM_MODELS,
        CLIP_T5_MODELS,
        GPT4V_MODELS,
        IMAGE_REWARD_MODELS,
        INSTRUCTBLIP_MODELS,
        LLAVA16_MODELS,
        LLAVA_LLAMA_MODELS,
        LLAVA_MODELS,
    )

    if name in GPT4V_MODELS:
        from .score import Score
        from .vqa_score import GPT4VScorer

        if complete is None:
            raise NotImplementedError(
                "GPT-4V scoring needs the injectable API transport: pass "
                "complete=lambda question, image: [(token, logprob), ...] "
                "(zero-egress environment; see vqa_score.GPT4VScorer)"
            )
        return Score(GPT4VScorer(complete, **kw).forward)

    dtype = dtype or jnp.float32
    meta, params = load_score_bundle(checkpoint)
    conversation = meta.get("conversation") or VQA_CONVERSATIONS.get(name)

    def model_cfg(cls):
        if "model" in meta:
            return config_from_dict(cls, meta["model"])
        return default_model_config(name)

    def need_tokenize(fn, what="tokenize"):
        if fn is not None:
            return fn, None
        hf = _bundle_hf_tokenizer(checkpoint)
        if hf is not None:
            return (lambda text: hf(text).input_ids), hf
        raise ValueError(
            f"{name!r} needs a tokenizer: pass {what}= or put an HF "
            f"tokenizer dir at <bundle>/tokenizer"
        )

    if name in LLAVA_MODELS + LLAVA_LLAMA_MODELS + LLAVA16_MODELS:
        from ..models.llava import Llava
        from .score import VQAScore

        cfg = model_cfg(LlavaConfig)
        quant = kw.pop("quant", None)
        # scan=True: lax.scan trunk — one compiled layer body instead of
        # 32, so a much faster cold compile at 7B; params restack
        # automatically
        scan = kw.pop("scan", False)
        if quant:
            # W8A8 trunk: ~6.9 GB instead of 13.5 GB for the 7B
            # (models/quant.py quantize_llava_trunk; bench.py vqa leg)
            from ..models.quant import quantize_llava_trunk

            model = Llava(cfg, dtype=dtype, quant_llm="dynamic",
                          scan_llm=scan)
            params = quantize_llava_trunk(params)
        else:
            model = Llava(cfg, dtype=dtype, scan_llm=scan)
        if scan:
            from ..models.llava import stack_llava_params

            params = stack_llava_params(params)
        tok, hf = need_tokenize(tokenize)
        if hf is not None:
            kw.setdefault("bos_token_id", hf.bos_token_id)
            kw.setdefault("pad_token_id", hf.pad_token_id or 0)
        return VQAScore(model, params, tok,
                        conversation_style=conversation or "chat", **kw)

    if name in CLIP_T5_MODELS:
        from ..models.clip_t5 import CLIPT5, CLIPT5Config
        from .score import T5VQAScore

        cfg = model_cfg(CLIPT5Config)
        quant = kw.pop("quant", None)
        if quant:
            # W8A8 T5 trunk: the xxl (11B, the reference default) drops
            # from ~22 GB bf16 to ~11.2 GB
            # (models/quant.py quantize_clip_t5_trunk; bench.py t5 leg)
            from ..models.quant import quantize_clip_t5_trunk

            model = CLIPT5(cfg, dtype=dtype, quant_t5="dynamic")
            params = quantize_clip_t5_trunk(params)
        else:
            model = CLIPT5(cfg, dtype=dtype)
        tok, _ = need_tokenize(tokenize)
        return T5VQAScore(
            model, params, tok,
            conversation_style=conversation or "t5_chat", **kw)

    if name in INSTRUCTBLIP_MODELS:
        from ..models.instructblip import InstructBlipConfig, InstructBlipT5
        from .score import InstructBlipVQAScore

        cfg = model_cfg(InstructBlipConfig)
        quant = kw.pop("quant", None)
        if quant:
            # W8A8 T5 trunk (the EVA-g tower + Q-Former stay fp): the xxl's
            # 11B T5 drops ~22 -> ~11.2 GB
            from ..models.quant import quantize_clip_t5_trunk

            model = InstructBlipT5(cfg, dtype=dtype, quant_t5="dynamic")
            params = quantize_clip_t5_trunk(params)
        else:
            model = InstructBlipT5(cfg, dtype=dtype)
        t5_tok, _ = need_tokenize(tokenize, "tokenize (T5)")
        q_tok = qformer_tokenize
        if q_tok is None:
            hf = _bundle_hf_tokenizer(checkpoint, "qformer_tokenizer")
            if hf is None:
                raise ValueError(
                    f"{name!r} needs qformer_tokenize= (BERT tokenizer) or "
                    "<bundle>/qformer_tokenizer"
                )
            q_tok = lambda text: hf(text).input_ids  # noqa: E731
        return InstructBlipVQAScore(model, params, q_tok, t5_tok, **kw)

    if name in BLIP2_ITM_MODELS:
        from ..models.blip2 import Blip2Config, Blip2ITM
        from .score import ITMScore

        cfg = model_cfg(Blip2Config)
        model = Blip2ITM(cfg, dtype=dtype)
        tok, _ = need_tokenize(tokenize)
        return ITMScore(model, params, tok,
                        image_size=cfg.vision.image_size, **kw)

    if name in BLIP2_ITC_MODELS:
        from ..models.blip2 import Blip2Config, Blip2ITM

        cfg = model_cfg(Blip2Config)
        model = Blip2ITM(cfg, dtype=dtype)
        tok, _ = need_tokenize(tokenize)
        return _blip2_itc_score(model, params, tok,
                                image_size=cfg.vision.image_size, **kw)

    if name in IMAGE_REWARD_MODELS:
        from ..models.blip import BlipConfig, ImageReward
        from .score import ImageRewardScore

        cfg = model_cfg(BlipConfig)
        model = ImageReward(cfg, dtype=dtype)
        tok, _ = need_tokenize(tokenize)
        return ImageRewardScore(model, params, tok,
                                image_size=cfg.vision.image_size, **kw)

    raise KeyError(f"unknown score model {name!r}")


def _blip2_itc_score(model, params, tokenize, image_size: int = 224,
                     max_length: int = 35, batch_size: int = 8):
    """BLIP2-ITC cosine score (t2v clipscore_models/blip2_itc_model.py:56-84):
    max over the Q-Former query embeddings of cosine(image query, text CLS)."""
    import jax
    import jax.numpy as jnp

    from ..image.preprocess import preprocess_batch
    from .score import Score

    @jax.jit
    def _embeds(params, pixels, ids, mask):
        img, txt = model.apply(
            {"params": params}, pixels, ids, mask, method="itc_embeds"
        )
        return jnp.einsum("bqe,be->bq", img, txt).max(axis=-1)

    def pair_forward(images, texts):
        out = np.zeros((len(images),), np.float32)
        for s in range(0, len(images), batch_size):
            imgs = images[s : s + batch_size]
            rows = [tokenize(t)[:max_length] for t in texts[s : s + batch_size]]
            ids = np.zeros((len(rows), max_length), np.int32)
            mask = np.zeros((len(rows), max_length), bool)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
                mask[i, : len(r)] = True
            import jax.numpy as jnp

            pixels = preprocess_batch(list(imgs), image_size, "clip")
            out[s : s + len(rows)] = np.asarray(_embeds(
                params, jnp.asarray(pixels), jnp.asarray(ids),
                jnp.asarray(mask),
            ))
        return out

    return Score(pair_forward)
