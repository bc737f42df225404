"""Model packaging/export — push_to_hf_hub equivalent.

Reference: open_clip/src/open_clip/push_to_hf_hub.py packages a model as
(weights + open_clip_config.json with model_cfg + preprocess_cfg) and
uploads it. Here ``save_model_bundle`` writes the same layout locally
(weights as .npz, config as JSON including the preprocess stats from the
pretrained table) and ``push_to_hub`` forwards the folder through
huggingface_hub when it is installed and authenticated (zero-egress
environments get a clear error instead).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from .config import CLIPConfig
from .factory import save_params_npz

WEIGHTS_NAME = "clip_embeds_model.npz"
CONFIG_NAME = "open_clip_config.json"


def _cfg_to_dict(cfg: CLIPConfig) -> Dict[str, Any]:
    out = dataclasses.asdict(cfg)
    # tuples -> lists for JSON round-tripping
    return json.loads(json.dumps(out))


def save_model_bundle(
    folder: str,
    model,
    params: Dict[str, Any],
    model_name: Optional[str] = None,
    pretrained_tag: Optional[str] = None,
) -> str:
    """Write weights + config (+ preprocess cfg) into ``folder``."""
    os.makedirs(folder, exist_ok=True)
    save_params_npz(params, os.path.join(folder, WEIGHTS_NAME))

    preprocess_cfg: Dict[str, Any] = {
        "size": model.cfg.vision.image_size,
        "mode": "RGB",
    }
    if model_name and pretrained_tag:
        from .openclip_registry import get_pretrained_cfg

        pc = get_pretrained_cfg(model_name, pretrained_tag)
        for k in ("mean", "std", "interpolation", "resize_mode"):
            if k in pc:
                preprocess_cfg[k] = pc[k]

    config = {
        "model_cfg": _cfg_to_dict(model.cfg),
        "preprocess_cfg": preprocess_cfg,
    }
    if model_name:
        config["model_name"] = model_name
    with open(os.path.join(folder, CONFIG_NAME), "w") as fh:
        json.dump(config, fh, indent=2)
    return folder


def load_model_bundle(folder: str):
    """(model, params) from a save_model_bundle folder."""
    import jax.numpy as jnp
    import numpy as np

    from ..models.clip import CLIP
    from .config import CLIPConfig, TextConfig, VisionConfig
    from .factory import unflatten_params

    with open(os.path.join(folder, CONFIG_NAME)) as fh:
        config = json.load(fh)
    mc = config["model_cfg"]
    vision = VisionConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in mc["vision"].items()
    })
    text = TextConfig(**mc["text"])
    cfg = CLIPConfig(**{
        **{k: v for k, v in mc.items() if k not in ("vision", "text")},
        "vision": vision, "text": text,
    })
    flat = dict(np.load(os.path.join(folder, WEIGHTS_NAME)))
    return CLIP(cfg), unflatten_params(flat)


def push_to_hub(
    folder: str,
    repo_id: str,
    token: Optional[str] = None,
    private: bool = False,
) -> None:
    """Upload a bundle folder (requires huggingface_hub + network)."""
    try:
        from huggingface_hub import HfApi
    except ImportError as e:
        raise RuntimeError(
            "push_to_hub needs the huggingface_hub package (not installed "
            "in this environment); the local bundle folder is complete and "
            "can be uploaded from any connected machine"
        ) from e
    api = HfApi(token=token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=folder, repo_id=repo_id)
