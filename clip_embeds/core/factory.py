"""Model factory: name -> (model, params), plus preprocess/tokenizer bundles.

JAX analogue of the reference factory (open_clip/src/open_clip/
factory.py:241-615 create_model, 822-960 create_model_and_transforms). Weight
sources are local files (torch .pt, numpy .npz, or orbax dirs) — there is no
network download path here; the torch converter handles the reference's
pretrained formats.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.clip import CLIP
from ..text.tokenizer import get_tokenizer
from .config import CLIPConfig, get_model_config
from .torch_convert import load_torch_checkpoint


def create_model(
    name: str,
    pretrained: Optional[str] = None,
    dtype: Any = jnp.float32,
    attn_impl: str = "auto",
    remat: bool = False,
    seed: int = 0,
    force_quick_gelu: bool = False,
    force_patch_dropout: Optional[float] = None,
) -> Tuple[CLIP, Dict[str, Any]]:
    """Build a CLIP model and its params.

    ``pretrained`` may be:
      * None — random init
      * 'openai' / another tag — sets QuickGELU etc. but still random init
        unless CLIP_EMBEDS_CKPT_DIR contains '<name>__<tag>.{pt,npz}'
      * a path to a torch checkpoint (.pt/.pth/.bin), .npz, or orbax dir
    """
    # every entry point funnels through here before its first compile; the
    # on-disk executable cache lets repeat runs skip the slow ones
    from .compile_cache import enable_persistent_cache

    enable_persistent_cache()

    # CoCa archs dispatch to their own model class, as the reference
    # factory does by config shape (factory.py "coca" in model_name)
    key = name.replace("/", "-")
    from .config import MODEL_CONFIGS

    if key not in MODEL_CONFIGS:
        from .openclip_registry import classify_model, get_raw_model_config

        if get_raw_model_config(key) is not None \
                and classify_model(key)[0] == "coca":
            return create_coca_model(
                key, pretrained, dtype=dtype, seed=seed,
                force_quick_gelu=force_quick_gelu,
            )

    cfg = get_model_config(name, pretrained)
    # train-time model overrides (reference params.py --force-quick-gelu /
    # --force-patch-dropout, main.py:221-229)
    if force_quick_gelu:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
    if force_patch_dropout is not None:
        cfg = dataclasses.replace(
            cfg,
            vision=dataclasses.replace(
                cfg.vision, patch_dropout=force_patch_dropout
            ),
        )
    model = CLIP(cfg, dtype=dtype, attn_impl=attn_impl, remat=remat)

    params = None
    path = None
    if pretrained and os.path.exists(pretrained):
        path = pretrained
    elif pretrained:
        ckpt_dir = os.environ.get("CLIP_EMBEDS_CKPT_DIR", "")
        for ext in (".pt", ".pth", ".bin", ".npz"):
            cand = os.path.join(ckpt_dir, f"{name}__{pretrained}{ext}")
            if ckpt_dir and os.path.exists(cand):
                path = cand
                break

    if path is not None:
        params = load_params(path, vision_tower=cfg.vision.tower)
    else:
        params = init_params(model, cfg, seed=seed)
    return model, params


def create_coca_model(
    name: str,
    pretrained: Optional[str] = None,
    dtype: Any = jnp.float32,
    seed: int = 0,
    force_quick_gelu: bool = False,
):
    """Build a CoCa model (+params) from a registry coca_* name.

    Mirrors create_model's pretrained resolution; torch checkpoints convert
    through torch_convert.convert_coca_state_dict."""
    from ..models.coca import CoCa
    from .openclip_registry import resolve_coca_config

    cfg = resolve_coca_config(name)
    if force_quick_gelu or pretrained in _QUICK_GELU_TAGS_COCA:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
    model = CoCa(cfg, dtype=dtype)

    path = None
    if pretrained and os.path.exists(pretrained):
        path = pretrained
    elif pretrained:
        ckpt_dir = os.environ.get("CLIP_EMBEDS_CKPT_DIR", "")
        for ext in (".pt", ".pth", ".bin", ".npz"):
            cand = os.path.join(ckpt_dir, f"{name}__{pretrained}{ext}")
            if ckpt_dir and os.path.exists(cand):
                path = cand
                break
    if path is not None:
        if path.endswith((".pt", ".pth", ".bin")):
            import torch

            from .torch_convert import convert_coca_state_dict

            sd = torch.load(path, map_location="cpu", weights_only=False)
            sd = sd.get("state_dict", sd)
            params = convert_coca_state_dict(sd)
        else:
            flat = dict(np.load(path))
            params = unflatten_params(flat)
    else:
        images = jnp.zeros(
            (1, cfg.vision.image_size, cfg.vision.image_size, 3))
        text = jnp.zeros((1, cfg.text.context_length), jnp.int32)
        params = model.init(jax.random.PRNGKey(seed), images, text)["params"]
    return model, params


_QUICK_GELU_TAGS_COCA: Tuple[str, ...] = ()


def init_params(model: CLIP, cfg: CLIPConfig, seed: int = 0) -> Dict[str, Any]:
    images = jnp.zeros((1, cfg.vision.image_size, cfg.vision.image_size, 3))
    text = jnp.zeros((1, cfg.text.context_length), jnp.int32)
    variables = model.init(jax.random.PRNGKey(seed), images, text)
    return variables["params"]


def load_params(path: str, vision_tower: Optional[str] = None) -> Dict[str, Any]:
    if path.endswith((".pt", ".pth", ".bin")):
        return load_torch_checkpoint(path, vision_tower=vision_tower)
    if path.endswith(".npz"):
        flat = dict(np.load(path))
        return unflatten_params(flat)
    from . import checkpoint as ckpt

    return ckpt.load(path)


def save_params_npz(params: Dict[str, Any], path: str) -> None:
    np.savez(path, **flatten_params(params))


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def create_model_and_transforms(
    name: str,
    pretrained: Optional[str] = None,
    aug_cfg=None,
    **kw,
):
    """(model, params, preprocess_fn, tokenizer) bundle like the reference API
    (factory.py:822-960).

    ``preprocess_fn`` honors the pretrained-table entry's preprocess cfg
    (mean/std/interpolation/resize_mode — pretrained.py _pcfg/_slpcfg/_apcfg)
    so e.g. SigLIP tags get squash-resize + 0.5 stats automatically. Pass
    ``aug_cfg`` (dict or image.transform.AugmentationCfg) to also get the
    train transform: the returned tuple grows a 5th element
    ``preprocess_train(image, rng)``.
    """
    from ..image.transform import image_transform_v2, pretrained_preprocess_cfg

    model, params = create_model(name, pretrained, **kw)
    size = model.cfg.vision.image_size
    tag = pretrained if (pretrained and not os.path.exists(pretrained)) else ""
    pp_cfg = pretrained_preprocess_cfg(name.replace("/", "-"), tag or "", size)
    preprocess = image_transform_v2(pp_cfg, is_train=False)
    tokenizer = get_tokenizer(model.cfg.text.context_length)
    if aug_cfg is not None:
        preprocess_train = image_transform_v2(pp_cfg, is_train=True,
                                              aug_cfg=aug_cfg)
        return model, params, preprocess, tokenizer, preprocess_train
    return model, params, preprocess, tokenizer
