"""Convert PyTorch CLIP checkpoints (open_clip / OpenAI layout) to JAX params.

The reference's ~154-entry pretrained registry (open_clip pretrained.py) is an
*input format*: this module maps a torch ``state_dict`` onto the flax param
tree of :class:`clip_embeds.models.clip.CLIP`. Key layout being consumed is
the reference CLIP class (open_clip/src/open_clip/model.py:222-301 — text
modules flattened at top level, packed ``in_proj_weight`` per block per
transformer.py:117).

Torch ``nn.Linear`` stores ``y = x @ W.T + b`` — flax ``Dense`` kernels are the
transpose. The patchify conv (transformer.py:549-556) becomes a dense kernel
with (kh, kw, cin) row ordering, matching ``models.vit.patchify``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    # torch tensor without importing torch at module scope
    return t.detach().cpu().float().numpy()


def _linear(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": _np(sd[prefix + ".weight"]),
        "bias": _np(sd[prefix + ".bias"]),
    }


def _block(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    in_proj_w = _np(sd[prefix + ".attn.in_proj_weight"])  # [3W, W]
    in_proj_b = _np(sd[prefix + ".attn.in_proj_bias"])
    return {
        "ln_1": _layernorm(sd, prefix + ".ln_1"),
        "attn": {
            "in_proj": {"kernel": in_proj_w.T, "bias": in_proj_b},
            "out_proj": _linear(sd, prefix + ".attn.out_proj"),
        },
        "ln_2": _layernorm(sd, prefix + ".ln_2"),
        "mlp": {
            "c_fc": _linear(sd, prefix + ".mlp.c_fc"),
            "c_proj": _linear(sd, prefix + ".mlp.c_proj"),
        },
    }


def _transformer(sd: Mapping[str, Any], prefix: str, layers: int) -> Dict[str, Any]:
    return {
        f"resblocks_{i}": _block(sd, f"{prefix}.resblocks.{i}")
        for i in range(layers)
    }


def _count_layers(sd: Mapping[str, Any], prefix: str) -> int:
    n = 0
    while f"{prefix}.resblocks.{n}.ln_1.weight" in sd:
        n += 1
    return n


def convert_clip_state_dict(
    sd: Mapping[str, Any], vision_tower: Optional[str] = None
) -> Dict[str, Any]:
    """open_clip CLIP state_dict -> flax params dict for models.clip.CLIP.

    Handles the plain CLIP layout, the ModifiedResNet tower, and
    CustomTextCLIP checkpoints with a timm trunk (visual.trunk.* + text.*,
    the EVA01/EVA02 layout). EVA01 and EVA02-E share an identical key set
    (fused qkv, plain MLP), so ``vision_tower`` ('eva' | 'eva02') picks the
    converter when the keys alone are ambiguous."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}

    is_fastvit = ("visual.trunk.stem.0.conv_kxk.0.conv.weight" in sd
                  or "visual.trunk.stem.0.rbr_conv.0.conv.weight" in sd)
    is_timm_trunk = ("visual.trunk.patch_embed.proj.weight" in sd
                     or "visual.trunk.patch_embed.backbone.stem.conv1.weight"
                     in sd
                     or "visual.trunk.patch_embed.backbone.0.conv.weight"
                     in sd
                     or is_fastvit)
    if is_timm_trunk:  # timm trunk under visual.trunk.*
        if (vision_tower == "mci-vit"
                or "visual.trunk.patch_embed.backbone.0.conv.weight" in sd):
            from ..models.mci_vit import convert_mci_vit_state_dict

            visual = convert_mci_vit_state_dict(sd)
        elif vision_tower == "timm-vit":
            from ..models.timm_vit import convert_timm_vit_state_dict

            visual = convert_timm_vit_state_dict(sd)
        elif vision_tower == "relpos-vit":
            from ..models.vit_relpos import convert_relpos_vit_state_dict

            visual = convert_relpos_vit_state_dict(sd)
        elif vision_tower == "swin":
            from ..models.swin import convert_swin_trunk_state_dict

            visual = convert_swin_trunk_state_dict(sd)
        elif vision_tower == "fastvit" or is_fastvit:
            from ..models.fastvit import (
                convert_fastvit_state_dict,
                infer_fastvit_config,
            )

            visual = convert_fastvit_state_dict(sd, infer_fastvit_config(sd))
        elif "visual.trunk.patch_embed.backbone.stem.conv1.weight" in sd:
            from ..models.vitamin import convert_vitamin_trunk_state_dict

            visual = convert_vitamin_trunk_state_dict(sd)
        else:
            from ..models.eva import (
                convert_eva02_trunk_state_dict,
                convert_eva_trunk_state_dict,
            )

            eva02_keys = any(
                ".attn.q_proj.weight" in k or ".mlp.fc1_g.weight" in k
                or ".attn.norm.weight" in k
                for k in sd
            )
            if vision_tower == "eva02" or (
                    vision_tower is None and eva02_keys):
                visual = convert_eva02_trunk_state_dict(sd)
            else:
                visual = convert_eva_trunk_state_dict(sd)
        # custom_text archs (EVA/ViTamin) carry the text tower under
        # 'text.'; plain-CLIP archs with a timm trunk (gap-vit / swin /
        # relpos-vit) keep the standard top-level text keys
        if "text.token_embedding.weight" in sd:
            text_sd = {k[len("text."):]: v for k, v in sd.items()
                       if k.startswith("text.")}
        else:
            text_sd = sd
        t_layers = _count_layers(text_sd, "transformer")
        text = {
            "token_embedding": {
                "embedding": _np(text_sd["token_embedding.weight"])
            },
            "positional_embedding": _np(text_sd["positional_embedding"]),
            "transformer": _transformer(text_sd, "transformer", t_layers),
            "ln_final": _layernorm(text_sd, "ln_final"),
            "text_projection": _np(text_sd["text_projection"]),
        }
        params: Dict[str, Any] = {
            "visual": visual,
            "text": text,
            "logit_scale": _np(sd["logit_scale"]).reshape(()),
        }
        if "logit_bias" in sd:
            params["logit_bias"] = _np(sd["logit_bias"]).reshape(())
        return params

    t_layers = _count_layers(sd, "transformer")

    if "visual.layer1.0.conv1.weight" in sd:  # ModifiedResNet tower
        visual = convert_modified_resnet_state_dict(sd, prefix="visual.")
    else:
        conv_w = _np(sd["visual.conv1.weight"])  # [W, 3, p, p]
        width, cin, p, _ = conv_w.shape
        patch_kernel = conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width)
        v_layers = _count_layers(sd, "visual.transformer")
        visual = {
            "patch_embed": {"kernel": patch_kernel},
            "class_embedding": _np(sd["visual.class_embedding"]),
            "positional_embedding": _np(sd["visual.positional_embedding"]),
            "ln_pre": _layernorm(sd, "visual.ln_pre"),
            "transformer": _transformer(sd, "visual.transformer", v_layers),
            "ln_post": _layernorm(sd, "visual.ln_post"),
            "proj": _np(sd["visual.proj"]),
        }
    text = {
        "token_embedding": {"embedding": _np(sd["token_embedding.weight"])},
        "positional_embedding": _np(sd["positional_embedding"]),
        "transformer": _transformer(sd, "transformer", t_layers),
        "ln_final": _layernorm(sd, "ln_final"),
        "text_projection": _np(sd["text_projection"]),
    }
    params: Dict[str, Any] = {
        "visual": visual,
        "text": text,
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
    }
    if "logit_bias" in sd:
        params["logit_bias"] = _np(sd["logit_bias"]).reshape(())
    return params


def load_torch_checkpoint(
    path: str, vision_tower: Optional[str] = None
) -> Dict[str, Any]:
    """Load a torch .pt/.pth checkpoint file and convert to flax params."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return convert_clip_state_dict(ckpt, vision_tower=vision_tower)


# -- Llama / LLaVA (HF layout) --------------------------------------------


def _dense_nb(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[key + ".weight"]).T}


def convert_llama_state_dict(
    sd: Mapping[str, Any], prefix: str = ""
) -> Dict[str, Any]:
    """HF LlamaForCausalLM state_dict -> params for models.llama.LlamaForCausalLM.

    HF key layout: model.embed_tokens / model.layers.N.{self_attn.{q,k,v,o}_proj,
    mlp.{gate,up,down}_proj, input_layernorm, post_attention_layernorm} /
    model.norm / lm_head.
    """
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    n = 0
    while f"model.layers.{n}.input_layernorm.weight" in sd:
        n += 1
    layers = {}
    for i in range(n):
        p = f"model.layers.{i}"
        layers[f"layers_{i}"] = {
            "input_layernorm": {"weight": _np(sd[p + ".input_layernorm.weight"])},
            "post_attention_layernorm": {
                "weight": _np(sd[p + ".post_attention_layernorm.weight"])
            },
            "self_attn": {
                name: _linear(sd, f"{p}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "o_proj")
            },
            "mlp": {
                name: _dense_nb(sd, f"{p}.mlp.{name}")
                for name in ("gate_proj", "up_proj", "down_proj")
            },
        }
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": _np(sd["model.embed_tokens.weight"])},
        "model": dict(layers, norm={"weight": _np(sd["model.norm.weight"])}),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = _dense_nb(sd, "lm_head")
    return params


def convert_hf_clip_vision_state_dict(
    sd: Mapping[str, Any], prefix: str = "vision_model."
) -> Dict[str, Any]:
    """HF CLIPVisionModel state_dict -> params for models.vit.VisionTransformer.

    HF keeps separate q/k/v projections (modeling_clip.py CLIPAttention); they
    pack into the in_proj layout in (q, k, v) order. Note HF's 'pre_layrnorm'
    typo. The final projection head is absent in CLIPVisionModel; a zero 'proj'
    is synthesized (never touched by the LLaVA hidden-layer tap).
    """
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    conv_w = _np(sd["embeddings.patch_embedding.weight"])  # [W, 3, p, p]
    width, cin, p, _ = conv_w.shape
    patch_kernel = conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width)

    n = 0
    while f"encoder.layers.{n}.layer_norm1.weight" in sd:
        n += 1

    blocks = {}
    for i in range(n):
        pre = f"encoder.layers.{i}"
        qw = _np(sd[f"{pre}.self_attn.q_proj.weight"])
        kw = _np(sd[f"{pre}.self_attn.k_proj.weight"])
        vw = _np(sd[f"{pre}.self_attn.v_proj.weight"])
        qb = _np(sd[f"{pre}.self_attn.q_proj.bias"])
        kb = _np(sd[f"{pre}.self_attn.k_proj.bias"])
        vb = _np(sd[f"{pre}.self_attn.v_proj.bias"])
        blocks[f"resblocks_{i}"] = {
            "ln_1": _layernorm(sd, f"{pre}.layer_norm1"),
            "attn": {
                "in_proj": {
                    "kernel": np.concatenate([qw, kw, vw], axis=0).T,
                    "bias": np.concatenate([qb, kb, vb], axis=0),
                },
                "out_proj": _linear(sd, f"{pre}.self_attn.out_proj"),
            },
            "ln_2": _layernorm(sd, f"{pre}.layer_norm2"),
            "mlp": {
                "c_fc": _linear(sd, f"{pre}.mlp.fc1"),
                "c_proj": _linear(sd, f"{pre}.mlp.fc2"),
            },
        }

    return {
        "patch_embed": {"kernel": patch_kernel},
        "class_embedding": _np(sd["embeddings.class_embedding"]),
        "positional_embedding": _np(sd["embeddings.position_embedding.weight"]),
        "ln_pre": _layernorm(sd, "pre_layrnorm"),
        "transformer": blocks,
        "ln_post": _layernorm(sd, "post_layernorm"),
        "proj": np.zeros((width, width), np.float32),
    }


def normalize_llava_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalize the newer transformers LLaVA layout (model.* wrapper) to the
    classic vision_tower./multi_modal_projector./language_model.model. keys."""
    sd = dict(sd)
    if not any(k.startswith("model.vision_tower.") for k in sd):
        return sd
    renamed = {}
    for k, v in sd.items():
        if k.startswith("model."):
            renamed[k[len("model."):]] = v
        else:
            renamed[k] = v
    if "lm_head.weight" in renamed:
        renamed["language_model.lm_head.weight"] = renamed.pop("lm_head.weight")
    # language_model.* here is the bare LM -> re-prefix with .model
    out: Dict[str, Any] = {}
    for k, v in renamed.items():
        if k.startswith("language_model.") and not k.startswith(
            ("language_model.model.", "language_model.lm_head")
        ):
            out["language_model.model." + k[len("language_model."):]] = v
        else:
            out[k] = v
    return out


def convert_llava_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF LlavaForConditionalGeneration state_dict -> models.llava.Llava params.

    HF layout (llava-hf/llava-1.5-*): vision_tower.vision_model.*,
    multi_modal_projector.linear_{1,2}, language_model.model.* +
    language_model.lm_head (newer transformers move lm_head under
    model.language_model; both spellings handled).
    """
    sd = normalize_llava_state_dict(sd)

    vision = convert_hf_clip_vision_state_dict(
        sd, prefix="vision_tower.vision_model."
    )
    projector = {
        "linear_1": _linear(sd, "multi_modal_projector.linear_1"),
        "linear_2": _linear(sd, "multi_modal_projector.linear_2"),
    }
    llama = convert_llama_state_dict(sd, prefix="language_model.")
    return {
        "vision_tower": vision,
        "multi_modal_projector": projector,
        "language_model": llama,
    }


def convert_qwen2_vl_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF Qwen2VLForConditionalGeneration -> models.qwen2_vl.Qwen2VL params.

    HF layout (older): visual.* + model.* + lm_head; (newer): model.visual.*
    + model.language_model.* + lm_head. Both handled."""
    sd = dict(sd)
    if any(k.startswith("model.visual.") for k in sd):
        renamed = {}
        for k, v in sd.items():
            if k.startswith("model.visual."):
                renamed["visual." + k[len("model.visual."):]] = v
            elif k.startswith("model.language_model."):
                renamed["model." + k[len("model.language_model."):]] = v
            else:
                renamed[k] = v
        sd = renamed

    conv_w = _np(sd["visual.patch_embed.proj.weight"])  # [D, C, tp, p, p]
    d = conv_w.shape[0]
    n_v = 0
    while f"visual.blocks.{n_v}.norm1.weight" in sd:
        n_v += 1
    blocks: Dict[str, Any] = {}
    for i in range(n_v):
        pre = f"visual.blocks.{i}"
        blocks[f"blocks_{i}"] = {
            "norm1": _layernorm(sd, f"{pre}.norm1"),
            "norm2": _layernorm(sd, f"{pre}.norm2"),
            "qkv": _linear(sd, f"{pre}.attn.qkv"),
            "proj": _linear(sd, f"{pre}.attn.proj"),
            "fc1": _linear(sd, f"{pre}.mlp.fc1"),
            "fc2": _linear(sd, f"{pre}.mlp.fc2"),
        }
    visual = dict(
        blocks,
        # conv3d with kernel==stride over processor layout (C, tp, ph, pw)
        patch_embed={"kernel": conv_w.reshape(d, -1).T},
        ln_q=_layernorm(sd, "visual.merger.ln_q"),
        merger_fc1=_linear(sd, "visual.merger.mlp.0"),
        merger_fc2=_linear(sd, "visual.merger.mlp.2"),
    )
    text = convert_llama_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("visual.")}
    )
    return {"visual": visual, "language_model": text}


def convert_llava_next_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF LlavaNextForConditionalGeneration -> models.llava_next.LlavaNext
    params: the LLaVA layout plus the learned image_newline embedding."""
    sd = dict(sd)
    newline_key = (
        "image_newline" if "image_newline" in sd else "model.image_newline"
    )
    newline = _np(sd.pop(newline_key))
    params = convert_llava_state_dict(sd)
    params["image_newline"] = newline
    return params


# -- ModifiedResNet (CLIP RN50 family) ------------------------------------


def _conv(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[key + ".weight"]).transpose(2, 3, 1, 0)}


def _bn(sd: Mapping[str, Any], key: str) -> Dict[str, np.ndarray]:
    return {
        "scale": _np(sd[key + ".weight"]),
        "bias": _np(sd[key + ".bias"]),
        "mean": _np(sd[key + ".running_mean"]),
        "var": _np(sd[key + ".running_var"]),
    }


def _convbn(sd, conv_key, bn_key):
    return {"conv": _conv(sd, conv_key), "bn": _bn(sd, bn_key)}


def convert_modified_resnet_state_dict(
    sd: Mapping[str, Any], prefix: str = "visual."
) -> Dict[str, Any]:
    """Reference ModifiedResNet state dict -> params (BN stats as params)."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {}
    for i in (1, 2, 3):
        params[f"stem{i}"] = _convbn(sd, f"conv{i}", f"bn{i}")

    for stage in (1, 2, 3, 4):
        i = 0
        while f"layer{stage}.{i}.conv1.weight" in sd:
            pre = f"layer{stage}.{i}"
            blk: Dict[str, Any] = {
                "c1": _convbn(sd, f"{pre}.conv1", f"{pre}.bn1"),
                "c2": _convbn(sd, f"{pre}.conv2", f"{pre}.bn2"),
                "c3": _convbn(sd, f"{pre}.conv3", f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = _convbn(
                    sd, f"{pre}.downsample.0", f"{pre}.downsample.1"
                )
            params[f"layer{stage}_{i}"] = blk
            i += 1

    params["attnpool"] = {
        "positional_embedding": _np(sd["attnpool.positional_embedding"]),
        "q_proj": _linear(sd, "attnpool.q_proj"),
        "k_proj": _linear(sd, "attnpool.k_proj"),
        "v_proj": _linear(sd, "attnpool.v_proj"),
        "c_proj": _linear(sd, "attnpool.c_proj"),
    }
    return params


# -- CoCa ------------------------------------------------------------------


def _attn_pooler(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    bq, bk, bv = np.split(_np(sd[prefix + ".attn.in_proj_bias"]), 3)
    return {
        "query": _np(sd[prefix + ".query"]),
        "ln_q": _layernorm(sd, prefix + ".ln_q"),
        "ln_k": _layernorm(sd, prefix + ".ln_k"),
        "q_proj": {"kernel": _np(sd[prefix + ".attn.q_proj_weight"]).T,
                   "bias": bq},
        "k_proj": {"kernel": _np(sd[prefix + ".attn.k_proj_weight"]).T,
                   "bias": bk},
        "v_proj": {"kernel": _np(sd[prefix + ".attn.v_proj_weight"]).T,
                   "bias": bv},
        "out_proj": _linear(sd, prefix + ".attn.out_proj"),
    }


def convert_coca_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Reference CoCa state_dict -> params for models.coca.CoCa."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}

    conv_w = _np(sd["visual.conv1.weight"])
    width, cin, p, _ = conv_w.shape
    v_layers = _count_layers(sd, "visual.transformer")
    visual = {
        "patch_embed": {
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width)
        },
        "class_embedding": _np(sd["visual.class_embedding"]),
        "positional_embedding": _np(sd["visual.positional_embedding"]),
        "ln_pre": _layernorm(sd, "visual.ln_pre"),
        "transformer": _transformer(sd, "visual.transformer", v_layers),
        "attn_pool": _attn_pooler(sd, "visual.attn_pool"),
        "ln_post": _layernorm(sd, "visual.ln_post"),
        "proj": _np(sd["visual.proj"]),
    }

    t_layers = _count_layers(sd, "text.transformer")
    text = {
        "token_embedding": {"embedding": _np(sd["text.token_embedding.weight"])},
        "positional_embedding": _np(sd["text.positional_embedding"]),
        "cls_emb": _np(sd["text.cls_emb"]),
        "transformer": _transformer(sd, "text.transformer", t_layers),
        "ln_final": _layernorm(sd, "text.ln_final"),
        "text_projection": _np(sd["text.text_projection"]),
    }

    d_layers = 0
    while f"text_decoder.resblocks.{d_layers}.ln_1.weight" in sd:
        d_layers += 1
    decoder: Dict[str, Any] = {}
    for i in range(d_layers):
        decoder[f"resblocks_{i}"] = _block(sd, f"text_decoder.resblocks.{i}")
        pre = f"text_decoder.cross_attn.{i}"
        decoder[f"cross_attn_{i}"] = {
            "ln_1": _layernorm(sd, pre + ".ln_1"),
            "ln_1_kv": _layernorm(sd, pre + ".ln_1_kv"),
            "in_proj_kernel": _np(sd[pre + ".attn.in_proj_weight"]).T,
            "in_proj_bias": _np(sd[pre + ".attn.in_proj_bias"]),
            "out_proj": _linear(sd, pre + ".attn.out_proj"),
            "ln_2": _layernorm(sd, pre + ".ln_2"),
            "mlp": {
                "c_fc": _linear(sd, pre + ".mlp.c_fc"),
                "c_proj": _linear(sd, pre + ".mlp.c_proj"),
            },
        }
    decoder["ln_final"] = _layernorm(sd, "text_decoder.ln_final")
    decoder["text_projection"] = _np(sd["text_decoder.text_projection"])

    return {
        "visual": visual,
        "text": text,
        "text_decoder": decoder,
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
    }


# -- T5 (HF layout) --------------------------------------------------------


def _t5_attn(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    out = {
        name: _dense_nb(sd, f"{prefix}.{name}") for name in ("q", "k", "v", "o")
    }
    if f"{prefix}.relative_attention_bias.weight" in sd:
        out["relative_attention_bias"] = {
            "embedding": _np(sd[f"{prefix}.relative_attention_bias.weight"])
        }
    return out


def _t5_stack(sd: Mapping[str, Any], prefix: str, is_decoder: bool) -> Dict[str, Any]:
    n = 0
    while f"{prefix}.block.{n}.layer.0.layer_norm.weight" in sd:
        n += 1
    stack: Dict[str, Any] = {}
    for i in range(n):
        p = f"{prefix}.block.{i}.layer"
        blk: Dict[str, Any] = {
            "self_ln": {"weight": _np(sd[f"{p}.0.layer_norm.weight"])},
            "self_attn": _t5_attn(sd, f"{p}.0.SelfAttention"),
        }
        ff_idx = 1
        if is_decoder:
            blk["cross_ln"] = {"weight": _np(sd[f"{p}.1.layer_norm.weight"])}
            blk["cross_attn"] = _t5_attn(sd, f"{p}.1.EncDecAttention")
            ff_idx = 2
        blk["ff_ln"] = {"weight": _np(sd[f"{p}.{ff_idx}.layer_norm.weight"])}
        ff_prefix = f"{p}.{ff_idx}.DenseReluDense"
        if f"{ff_prefix}.wi_0.weight" in sd:
            blk["ff"] = {
                "wi_0": _dense_nb(sd, f"{ff_prefix}.wi_0"),
                "wi_1": _dense_nb(sd, f"{ff_prefix}.wi_1"),
                "wo": _dense_nb(sd, f"{ff_prefix}.wo"),
            }
        else:
            blk["ff"] = {
                "wi": _dense_nb(sd, f"{ff_prefix}.wi"),
                "wo": _dense_nb(sd, f"{ff_prefix}.wo"),
            }
        stack[f"block_{i}"] = blk
    stack["final_ln"] = {"weight": _np(sd[f"{prefix}.final_layer_norm.weight"])}
    return stack


def convert_t5_state_dict(sd: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """HF T5ForConditionalGeneration -> params for models.t5."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    params: Dict[str, Any] = {
        "shared": {"embedding": _np(sd["shared.weight"])},
        "encoder": _t5_stack(sd, "encoder", is_decoder=False),
        "decoder": _t5_stack(sd, "decoder", is_decoder=True),
    }
    if "lm_head.weight" in sd:
        params["lm_head"] = _dense_nb(sd, "lm_head")
    return params


# -- BLIP-2 (HF Blip2ForImageTextRetrieval layout) -------------------------


def _bert_attn(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {
        "query": _linear(sd, f"{prefix}.attention.query"),
        "key": _linear(sd, f"{prefix}.attention.key"),
        "value": _linear(sd, f"{prefix}.attention.value"),
        "out_dense": _linear(sd, f"{prefix}.output.dense"),
        "out_ln": _layernorm(sd, f"{prefix}.output.LayerNorm"),
    }


def _blip2_vision(sd: Mapping[str, Any], prefix: str = "vision_model") -> Dict[str, Any]:
    """HF Blip2/InstructBlip vision model -> Blip2VisionTower params."""
    conv_w = _np(sd[f"{prefix}.embeddings.patch_embedding.weight"])
    width, cin, p, _ = conv_w.shape
    n_v = 0
    while f"{prefix}.encoder.layers.{n_v}.layer_norm1.weight" in sd:
        n_v += 1
    v_blocks = {}
    for i in range(n_v):
        pre = f"{prefix}.encoder.layers.{i}"
        v_blocks[f"resblocks_{i}"] = {
            "ln_1": _layernorm(sd, f"{pre}.layer_norm1"),
            "attn": {
                "in_proj": _linear(sd, f"{pre}.self_attn.qkv"),
                "out_proj": _linear(sd, f"{pre}.self_attn.projection"),
            },
            "ln_2": _layernorm(sd, f"{pre}.layer_norm2"),
            "mlp": {
                "c_fc": _linear(sd, f"{pre}.mlp.fc1"),
                "c_proj": _linear(sd, f"{pre}.mlp.fc2"),
            },
        }
    return {
        "patch_embed": {
            "kernel": conv_w.transpose(2, 3, 1, 0).reshape(p * p * cin, width),
            "bias": _np(sd[f"{prefix}.embeddings.patch_embedding.bias"]),
        },
        "class_embedding": _np(
            sd[f"{prefix}.embeddings.class_embedding"]
        ).reshape(-1),
        "positional_embedding": _np(
            sd[f"{prefix}.embeddings.position_embedding"]
        ).reshape(-1, width),
        "transformer": v_blocks,
        "post_layernorm": _layernorm(sd, f"{prefix}.post_layernorm"),
    }


def _qformer_layers(sd: Mapping[str, Any], prefix: str = "qformer") -> Dict[str, Any]:
    """HF Blip2/InstructBlip Q-Former encoder layers -> QFormer layer params
    (without the input layernorm, whose key differs between the two)."""
    n_q = 0
    while f"{prefix}.encoder.layer.{n_q}.attention.attention.query.weight" in sd:
        n_q += 1
    q_layers: Dict[str, Any] = {}
    for i in range(n_q):
        pre = f"{prefix}.encoder.layer.{i}"
        layer: Dict[str, Any] = {
            "attention": _bert_attn(sd, f"{pre}.attention"),
            "ffn_query": {
                "intermediate": _linear(sd, f"{pre}.intermediate_query.dense"),
                "output": _linear(sd, f"{pre}.output_query.dense"),
                "ln": _layernorm(sd, f"{pre}.output_query.LayerNorm"),
            },
        }
        if f"{pre}.crossattention.attention.query.weight" in sd:
            layer["crossattention"] = _bert_attn(sd, f"{pre}.crossattention")
        if f"{pre}.intermediate.dense.weight" in sd:
            layer["ffn"] = {
                "intermediate": _linear(sd, f"{pre}.intermediate.dense"),
                "output": _linear(sd, f"{pre}.output.dense"),
                "ln": _layernorm(sd, f"{pre}.output.LayerNorm"),
            }
        q_layers[f"layer_{i}"] = layer
    return q_layers


def convert_blip2_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF Blip2ForImageTextRetrieval -> params for models.blip2.Blip2ITM."""
    sd = dict(sd)
    return {
        "vision_model": _blip2_vision(sd),
        "query_tokens": _np(sd["query_tokens"]).reshape(
            -1, _np(sd["query_tokens"]).shape[-1]
        ),
        "word_embeddings": {
            "embedding": _np(sd["embeddings.word_embeddings.weight"])
        },
        "position_embeddings": {
            "embedding": _np(sd["embeddings.position_embeddings.weight"])
        },
        "qformer": dict(
            _qformer_layers(sd), input_ln=_layernorm(sd, "qformer.layernorm")
        ),
        "vision_projection": _linear(sd, "vision_projection"),
        "text_projection": _linear(sd, "text_projection"),
        "itm_head": _linear(sd, "itm_head"),
    }


def convert_instructblip_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF InstructBlipForConditionalGeneration (FlanT5 LM) ->
    params for models.instructblip.InstructBlipT5."""
    sd = dict(sd)
    return {
        "vision_model": _blip2_vision(sd),
        "query_tokens": _np(sd["query_tokens"]).reshape(
            -1, _np(sd["query_tokens"]).shape[-1]
        ),
        "word_embeddings": {
            "embedding": _np(sd["qformer.embeddings.word_embeddings.weight"])
        },
        "position_embeddings": {
            "embedding": _np(
                sd["qformer.embeddings.position_embeddings.weight"]
            )
        },
        "qformer": dict(
            _qformer_layers(sd),
            input_ln=_layernorm(sd, "qformer.embeddings.layernorm"),
        ),
        "language_projection": _linear(sd, "language_projection"),
        "t5": convert_t5_state_dict(sd, prefix="language_model."),
    }


def convert_clip_t5_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """CLIPT5ForConditionalGeneration (clip-flant5-* checkpoints) ->
    params for models.clip_t5.CLIPT5.

    Reference layout (t2v clip_t5/model/language_model/clip_t5.py:44-54):
    plain T5 keys at top level plus ``vision_tower.vision_tower.*`` (an HF
    CLIPVisionModel) and ``mm_projector.{0,2}`` (the mlp2x_gelu Sequential,
    builder.py:32-44).
    """
    sd = dict(sd)
    vision = convert_hf_clip_vision_state_dict(
        sd, prefix="vision_tower.vision_tower.vision_model."
    )
    projector = {
        "linear_1": _linear(sd, "mm_projector.0"),
        "linear_2": _linear(sd, "mm_projector.2"),
    }
    t5_sd = {
        k: v for k, v in sd.items()
        if not k.startswith(("vision_tower.", "mm_projector.",
                             "embed_tokens."))
    }
    return {
        "vision_tower": vision,
        "multi_modal_projector": projector,
        "t5": convert_t5_state_dict(t5_sd),
    }


def convert_qwen2_5_vl_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """HF Qwen2_5_VLForConditionalGeneration -> models.qwen2_vl.Qwen25VL.

    Same layouts as convert_qwen2_vl_state_dict but the vision blocks carry
    RMSNorm (weight-only) and gate/up/down SiLU MLPs, and the merger's ln_q
    is an RMSNorm (reference VLM2Vec/src/vlm_backbone/qwen2_5_vl)."""
    sd = dict(sd)
    if any(k.startswith("model.visual.") for k in sd):
        renamed = {}
        for k, v in sd.items():
            if k.startswith("model.visual."):
                renamed["visual." + k[len("model.visual."):]] = v
            elif k.startswith("model.language_model."):
                renamed["model." + k[len("model.language_model."):]] = v
            else:
                renamed[k] = v
        sd = renamed

    def _rms(prefix):
        return {"weight": _np(sd[prefix + ".weight"])}

    conv_w = _np(sd["visual.patch_embed.proj.weight"])  # [D, C, tp, p, p]
    d = conv_w.shape[0]
    n_v = 0
    while f"visual.blocks.{n_v}.norm1.weight" in sd:
        n_v += 1
    blocks: Dict[str, Any] = {}
    for i in range(n_v):
        pre = f"visual.blocks.{i}"
        blocks[f"blocks_{i}"] = {
            "norm1": _rms(f"{pre}.norm1"),
            "norm2": _rms(f"{pre}.norm2"),
            "qkv": _linear(sd, f"{pre}.attn.qkv"),
            "proj": _linear(sd, f"{pre}.attn.proj"),
            "gate_proj": _linear(sd, f"{pre}.mlp.gate_proj"),
            "up_proj": _linear(sd, f"{pre}.mlp.up_proj"),
            "down_proj": _linear(sd, f"{pre}.mlp.down_proj"),
        }
    visual = dict(
        blocks,
        patch_embed={"kernel": conv_w.reshape(d, -1).T},
        ln_q=_rms("visual.merger.ln_q"),
        merger_fc1=_linear(sd, "visual.merger.mlp.0"),
        merger_fc2=_linear(sd, "visual.merger.mlp.2"),
    )
    text = convert_llama_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("visual.")}
    )
    return {"visual": visual, "language_model": text}


def convert_pacl_head_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """PACL/SPARC projection-head weights -> flax PACLHead/SPARCHead params.

    The reference heads are nn.Sequential stacks (pacl.py:58-79 and the
    identical sparc ones, :388-409): ``visual_projection.0`` LayerNorm ->
    ``.1`` Dropout -> ``.2`` Patch_Projection (``linear_projection.0`` plus
    ``non_linear_projection.{0,2}``); ``text_projection.{0,1,2}`` =
    LayerNorm -> Dropout -> Linear. Patch_Projection also aliases
    ``text_projection`` to the same Sequential (pacl.py:39), so its
    duplicated keys are ignored here. Accepts 'module.'-prefixed
    (DataParallel) checkpoints like eval_pacl.py:381-388.
    """
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    return {
        "visual_projection": {
            "ln": _layernorm(sd, "visual_projection.0"),
            "proj": {
                "linear": _linear(sd, "visual_projection.2.linear_projection.0"),
                "mlp_in": _linear(sd, "visual_projection.2.non_linear_projection.0"),
                "mlp_out": _linear(sd, "visual_projection.2.non_linear_projection.2"),
            },
        },
        "text_projection": {
            "ln": _layernorm(sd, "text_projection.0"),
            "proj": _linear(sd, "text_projection.2"),
        },
    }


def split_pacl_checkpoint(sd: Mapping[str, Any]):
    """One reference PACL/SPARC checkpoint -> (clip torch sub-state-dict,
    flax head params).

    The reference trains with nn.DataParallel and saves the WHOLE module
    (frozen tower + heads) with 'module.' prefixes (train_pacl.py:133;
    loaded back in eval_pacl.py:372-391). The tower sub-dict keeps torch
    key layout ('clip_model.' stripped) so it feeds create_model(...,
    pretrained=...) like any open_clip checkpoint; the heads convert to
    flax for PACLHead/SPARCHead.
    """
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    clip_sd = {k[len("clip_model."):]: v for k, v in sd.items()
               if k.startswith("clip_model.")}
    head_sd = {k: v for k, v in sd.items()
               if k.startswith(("visual_projection.", "text_projection."))}
    return clip_sd, convert_pacl_head_state_dict(head_sd)
