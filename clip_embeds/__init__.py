"""clip_embeds — CLIP embedding & evaluation framework in JAX.

One coherent JAX/XLA package with the capabilities of the reference
lst627/CLIP-Embeds stack (see SURVEY.md for the blueprint).
"""

from .core.config import CLIPConfig, TextConfig, VisionConfig, get_model_config, list_models
from .core.factory import create_model, create_model_and_transforms
from .text.tokenizer import BPETokenizer, get_tokenizer

# t2v_metrics-style public scoring surface (reference t2v_metrics/__init__.py)
from .scores.registry import (
    get_score_model,
    list_all_clipscore_models,
    list_all_itmscore_models,
    list_all_models,
    list_all_vqascore_models,
)
from .scores.score import (
    CLIPScore,
    ITMScore,
    ImageRewardScore,
    InstructBlipVQAScore,
    Score,
    VQAScore,
)

__version__ = "0.2.0"
