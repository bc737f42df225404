"""Extract the open_clip model-config + pretrained-weights registry DATA.

Reads the reference fork's ``model_configs/*.json`` (126 files) and
``pretrained.py`` (~158 (arch, tag) entries — reference
open_clip/src/open_clip/pretrained.py:93-660) and emits one JSON data file,
``clip_embeds/core/reference_registry.json``, that the JAX factory loads.

This extracts *configuration data only* (tower shapes, checkpoint URLs/HF-hub
ids, preprocess statistics). The reference tables are built by `_pcfg`-style
helper calls; we re-create those defaults here (the means/stds are the public
OpenAI/ImageNet/Inception constants) and evaluate only the literal
``dict(...)`` table expressions via ``ast`` — no reference code is executed.

Run from the repo root:  python tools/extract_registry.py
"""

from __future__ import annotations

import ast
import copy
import json
import os
import sys

REF = "/root/reference/open_clip/src/open_clip"
OUT = os.path.join(
    os.path.dirname(__file__), "..",
    "clip_embeds", "core", "reference_registry.json",
)

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_MEAN = (0.5, 0.5, 0.5)
INCEPTION_STD = (0.5, 0.5, 0.5)


def _cfg_factory(mean, std, interpolation, resize_mode):
    def make(url="", hf_hub="", **kw):
        out = {
            "url": url,
            "hf_hub": hf_hub,
            "mean": list(mean),
            "std": list(std),
            "interpolation": interpolation,
            "resize_mode": resize_mode,
        }
        out.update(kw)
        return out

    return make


HELPERS = {
    # defaults per reference pretrained.py:40-89
    "_pcfg": _cfg_factory(OPENAI_MEAN, OPENAI_STD, "bicubic", "shortest"),
    "_slpcfg": _cfg_factory(INCEPTION_MEAN, INCEPTION_STD, "bicubic", "squash"),
    "_apcfg": _cfg_factory(IMAGENET_MEAN, IMAGENET_STD, "bilinear", "squash"),
    "_mccfg": _cfg_factory((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), "bilinear", "shortest"),
    "dict": dict,
    "IMAGENET_MEAN": list(IMAGENET_MEAN),
    "IMAGENET_STD": list(IMAGENET_STD),
    "INCEPTION_MEAN": list(INCEPTION_MEAN),
    "INCEPTION_STD": list(INCEPTION_STD),
    "OPENAI_DATASET_MEAN": list(OPENAI_MEAN),
    "OPENAI_DATASET_STD": list(OPENAI_STD),
}


def extract_pretrained() -> dict:
    with open(os.path.join(REF, "pretrained.py")) as fh:
        tree = ast.parse(fh.read())

    env = dict(HELPERS)
    table = None
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        name = tgt.id
        if name == "_PRETRAINED_quickgelu":
            break  # derived below, in our own code
        if not name.startswith("_") or name in ("_has_safetensors", "_has_hf_hub"):
            continue
        is_table_expr = isinstance(node.value, (ast.Dict,)) or (
            isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Name)
            and node.value.func.id == "dict"
        )
        if not is_table_expr:
            continue
        code = compile(ast.Expression(node.value), "<registry>", "eval")
        env[name] = eval(code, {"__builtins__": {}}, env)  # data only
        if name == "_PRETRAINED":
            table = env[name]

    assert table, "did not find _PRETRAINED"
    # reference pretrained.py:651-659: -quickgelu aliases for quick_gelu tags
    quickgelu = {}
    for arch, tags in table.items():
        qg = {t: copy.deepcopy(c) for t, c in tags.items() if c.get("quick_gelu")}
        if qg:
            quickgelu[arch + "-quickgelu"] = qg
    table = dict(table)
    table.update(quickgelu)
    return table


def extract_model_configs() -> dict:
    cfg_dir = os.path.join(REF, "model_configs")
    out = {}
    for fn in sorted(os.listdir(cfg_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(cfg_dir, fn)) as fh:
                out[fn[:-5]] = json.load(fh)
    return out

def main() -> None:
    registry = {
        "model_configs": extract_model_configs(),
        "pretrained": extract_pretrained(),
    }
    n_cfg = len(registry["model_configs"])
    n_tag = sum(len(v) for v in registry["pretrained"].values())
    with open(os.path.abspath(OUT), "w") as fh:
        json.dump(registry, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {n_cfg} model configs, {n_tag} pretrained entries -> {OUT}")


if __name__ == "__main__":
    sys.exit(main())
