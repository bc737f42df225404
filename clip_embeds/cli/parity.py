"""Accuracy-parity runbook: the reference torch eval vs this repo's JAX eval.

One command that, given a checkpoint and a dataset root, runs BOTH
  * the reference eval driver — the actual eval/eval_4/eval_COCO_VG/eval_MMVP
    functions from Patch-Aligned-Contrastive-Learning/eval_clip.py,
    eval_pacl.py, or eval_sparc.py (--driver), executed from /root/reference
    with the reference torch model on CPU, and
  * this repo's JAX eval (cli/eval.py)
and diffs the per-metric accuracy tables (BASELINE.md parity column — all
three drivers it names are covered).

    python -m clip_embeds.cli.parity --model ViT-L-14-336 \
        --checkpoint /path/vitl336.pt --dataset a --root-dir /data/whatsup \
        --out parity_report.json

    python -m clip_embeds.cli.parity --driver pacl \
        --model ViT-L-14-336 --checkpoint /path/pacl_all.pth \
        --dataset a --root-dir /data/whatsup     # DataParallel ckpt, split
                                                 # tower/heads automatically

    python -m clip_embeds.cli.parity --driver sparc --local \
        --model ViT-L-14-336 --checkpoint /path/sparc.pth --dataset mmvpvlm \
        --root-dir /data/MMVP_VLM

Notes on fidelity:
  * The eval functions are extracted from eval_clip.py by AST (its module
    level hardcodes cuda:0 and a checkpoint download) and run unmodified.
  * torchvision is absent in this image, so ``--`` the reference val
    transform (open_clip transform.py: shortest-edge bicubic Resize ->
    CenterCrop -> ToTensor -> Normalize(OpenAI stats)) is re-created here on
    PIL + torch following torchvision's exact arithmetic (int() truncation
    on the resize ratio, round() on the crop offset). Tokenization is the
    reference SimpleTokenizer imported from /root/reference.
  * Exit code 1 if any shared metric differs by more than --tol.

Proven end-to-end on synthetic fixtures + tiny converted checkpoints in
tests/test_parity_runbook.py; with real weights + datasets it is a
dataset-drop away (same command).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import tempfile
import types
from typing import Dict

REF_ROOT = "/root/reference"
REF_PACL_DIR = f"{REF_ROOT}/Patch-Aligned-Contrastive-Learning"
REF_EVAL_CLIP = f"{REF_PACL_DIR}/eval_clip.py"
REF_EVAL_PACL = f"{REF_PACL_DIR}/eval_pacl.py"
REF_EVAL_SPARC = f"{REF_PACL_DIR}/eval_sparc.py"
REF_PACL_MODEL = f"{REF_PACL_DIR}/model/pacl.py"
OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds parity runbook")
    p.add_argument("--driver", default="clip",
                   choices=["clip", "pacl", "sparc"],
                   help="which reference eval driver to diff against: "
                        "eval_clip.py, eval_pacl.py, or eval_sparc.py "
                        "(BASELINE.md names all three)")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--checkpoint", required=True,
                   help="torch checkpoint evaluated by BOTH sides: a CLIP "
                        ".pt for --driver clip, or the reference "
                        "DataParallel 'module.'-prefixed PACL/SPARC "
                        "checkpoint (tower + heads, train_pacl.py:133)")
    p.add_argument("--rope", default="none",
                   choices=["none", "before", "after"],
                   help="PACL/SPARC rope variant (eval_pacl.py picks it "
                        "from the checkpoint filename; here it is explicit)")
    p.add_argument("--local", action="store_true",
                   help="SPARC local (grouped-patch) scoring "
                        "(eval_sparc.py --local)")
    p.add_argument("--dataset", default="a",
                   choices=["a", "b", "a4", "b4", "cocoone", "cocotwo",
                            "vgone", "vgtwo", "mmvp", "mmvpvlm"])
    p.add_argument("--root-dir", required=True)
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="max |reference - jax| accuracy difference (pct)")
    p.add_argument("--precision", default="fp32",
                   choices=["bf16", "fp32"],
                   help="JAX-side dtype (fp32 recommended for exactness)")
    return p.parse_args(argv)


# -- reference side -----------------------------------------------------------


def _load_refoc():
    """Import the reference open_clip package from /root/reference with the
    same stubs the parity tests use (ftfy / torchvision are absent)."""
    import importlib
    import importlib.machinery

    import torch

    if "ftfy" not in sys.modules:
        stub = types.ModuleType("ftfy")
        stub.fix_text = lambda t: t
        stub.__spec__ = importlib.machinery.ModuleSpec("ftfy", None)
        sys.modules["ftfy"] = stub
    if "torchvision" not in sys.modules:
        for name in ("torchvision", "torchvision.ops",
                     "torchvision.ops.misc"):
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = mod
        sys.modules["torchvision.ops.misc"].FrozenBatchNorm2d = (
            torch.nn.BatchNorm2d
        )
    pkg = types.ModuleType("refoc")
    pkg.__path__ = [f"{REF_ROOT}/open_clip/src/open_clip"]
    sys.modules.setdefault("refoc", pkg)
    return (importlib.import_module("refoc.model"),
            importlib.import_module("refoc.tokenizer"))


def _build_ref_tower(model_name: str):
    """Bare reference torch CLIP with the named architecture (no weights)."""
    from ..core.config import get_model_config

    refoc_model, _ = _load_refoc()
    cfg = get_model_config(model_name)
    model = refoc_model.CLIP(
        embed_dim=cfg.embed_dim,
        vision_cfg=dict(
            image_size=cfg.vision.image_size, patch_size=cfg.vision.patch_size,
            width=cfg.vision.width, layers=cfg.vision.layers,
            head_width=cfg.vision.head_width,
            mlp_ratio=cfg.vision.mlp_ratio,
        ),
        text_cfg=dict(
            context_length=cfg.text.context_length,
            vocab_size=cfg.text.vocab_size, width=cfg.text.width,
            heads=cfg.text.heads, layers=cfg.text.layers,
        ),
        quick_gelu=cfg.quick_gelu,
    )
    return model, cfg


def build_reference_model(model_name: str, checkpoint: str):
    """Reference torch CLIP with the named architecture + local weights."""
    import torch

    model, cfg = _build_ref_tower(model_name)
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    model.load_state_dict(sd)
    model.eval()
    return model, cfg


class _RefProcess:
    """prepare_data_clip equivalent (PACL data/utils.py:57-70) without
    torchvision: shortest-edge bicubic resize (size ratio truncated with
    int(), as torchvision F.resize does), round()-offset center crop,
    ToTensor, Normalize(OpenAI stats); reference SimpleTokenizer text side."""

    def __init__(self, image_size: int, tokenizer):
        self.image_size = image_size
        self.tokenizer = tokenizer

    def _one(self, image):
        import numpy as np
        import torch
        from PIL import Image as PILImage

        s = self.image_size
        image = image.convert("RGB")
        w, h = image.size
        if w <= h:
            ow, oh = s, int(s * h / w)
        else:
            ow, oh = int(s * w / h), s
        image = image.resize((ow, oh), PILImage.BICUBIC)
        left = int(round((ow - s) / 2.0))
        top = int(round((oh - s) / 2.0))
        image = image.crop((left, top, left + s, top + s))
        x = torch.from_numpy(
            np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0
        )
        mean = torch.tensor(OPENAI_MEAN).view(3, 1, 1)
        std = torch.tensor(OPENAI_STD).view(3, 1, 1)
        return (x - mean) / std

    def preprocess_image(self, image):
        import torch

        if isinstance(image, list):
            return torch.stack([self._one(im) for im in image])
        return self._one(image)

    def preprocess_text(self, caption):
        return self.tokenizer(caption)


def load_reference_eval_fns(ns: Dict, path: str = REF_EVAL_CLIP) -> Dict:
    """AST-extract eval/eval_4/eval_COCO_VG/eval_MMVP from a reference eval
    driver and exec them (unmodified) into ``ns`` — skipping the module-level
    cuda/model setup (eval_clip.py:19-28, eval_pacl.py:14-22)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("eval", "eval_4", "eval_COCO_VG", "eval_MMVP")]
    mod = ast.Module(body=fns, type_ignores=[])
    exec(compile(mod, path, "exec"), ns)
    return ns


# -- reference PACL/SPARC side -------------------------------------------------


class _PaclRefProcess:
    """prepare_data equivalent (PACL data/utils.py:30-55) without
    torchvision: ToTensor -> T.Resize((S, S)) on the tensor (bilinear,
    antialias — torchvision F.resize semantics) -> Normalize(IMAGENET
    stats; the reference deliberately uses ImageNet, not CLIP, stats here).
    Text side: reference SimpleTokenizer."""

    def __init__(self, image_size: int, tokenizer):
        self.image_size = image_size
        self.tokenizer = tokenizer

    def _one(self, image):
        import numpy as np
        import torch
        import torch.nn.functional as F

        s = self.image_size
        x = torch.from_numpy(
            np.asarray(image.convert("RGB"), np.float32).transpose(2, 0, 1)
            / 255.0
        )
        x = F.interpolate(
            x[None], size=(s, s), mode="bilinear", align_corners=False,
            antialias=True,
        )[0]
        mean = torch.tensor(IMAGENET_MEAN).view(3, 1, 1)
        std = torch.tensor(IMAGENET_STD).view(3, 1, 1)
        return (x - mean) / std

    def preprocess_image(self, image):
        import torch

        if isinstance(image, list):
            return torch.stack([self._one(im) for im in image])
        return self._one(image)

    def preprocess_text(self, caption):
        return self.tokenizer(caption)


def _load_ref_pacl_ns(model_name: str) -> Dict:
    """exec the reference model/pacl.py class+function defs unmodified.

    The only substitution is the module's ``oc`` import: pacl.py's
    constructors call oc.create_model_and_transforms(<name>,
    pretrained='openai'/...) which would download weights (zero egress
    here) — the injected factory builds the same reference torch CLIP
    class locally with ``model_name``'s architecture instead, weights
    blank. That is weight-neutral for the runbook: eval_pacl.py:381-388
    overwrites EVERY tower weight from the checkpoint anyway.
    """
    import torch
    import torch.nn.functional as F
    from torch import nn

    refoc_model, ref_tok = _load_refoc()

    class _OC:
        @staticmethod
        def create_model_and_transforms(name, pretrained=None, **kw):
            model, _cfg = _build_ref_tower(model_name)
            return model, None, None

        @staticmethod
        def get_tokenizer(name):
            return ref_tok.SimpleTokenizer()

    try:
        from transformers import AutoConfig, AutoModel, AutoTokenizer
    except Exception:  # pragma: no cover - transformers is baked in
        AutoConfig = AutoModel = AutoTokenizer = None

    ns: Dict = {
        "torch": torch, "nn": nn, "F": F, "oc": _OC,
        "AutoModel": AutoModel, "AutoConfig": AutoConfig,
        "AutoTokenizer": AutoTokenizer, "os": os, "sys": sys,
    }
    with open(REF_PACL_MODEL) as f:
        tree = ast.parse(f.read())
    defs = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    mod = ast.Module(body=defs, type_ignores=[])
    exec(compile(mod, REF_PACL_MODEL, "exec"), ns)
    return ns


def build_reference_pacl(args):
    """Reference PACL/SPARC torch model per eval_pacl.py:372-391 /
    eval_sparc.py:366-380: pick the class by rope variant, then load the
    DataParallel checkpoint through the 'module.'-prefix loop exactly as the
    reference does (missing keys raise)."""
    import torch

    from ..core.config import get_model_config

    ns = _load_ref_pacl_ns(args.model)
    # eval_pacl.py:372 infers the base from the checkpoint filename
    # ("all" -> ViT-L-14-336); here the branch must match the head dims of
    # the checkpoint, which for every reference recipe is the ViT-L branch
    # unless the tower IS ViT-B-16
    base = "ViT-B-16" if args.model == "ViT-B-16" else "ViT-L-14-336"
    if args.driver == "pacl":
        cls = {"none": ns["open_clip_pacl"],
               "before": ns["open_clip_pacl_rope"],
               "after": ns["open_clip_pacl_rope_after"]}[args.rope]
        model = cls(base_model=base)
    else:
        cls = ns["sparc_rope"] if args.rope != "none" else ns["sparc"]
        model = cls(base_model=base)

    saved_weights = torch.load(args.checkpoint, map_location="cpu",
                               weights_only=True)
    model_weights = model.state_dict()
    for name in model_weights:
        model_weights[name] = saved_weights["module." + name]
    for name in saved_weights:
        if name[7:] not in model_weights:
            raise ValueError(f"{name} in weights is not included")
    model.load_state_dict(model_weights)
    for p in model.parameters():
        p.requires_grad = False
    model.eval()
    cfg = get_model_config(args.model)
    return model, cfg


def run_reference_driver(args, workdir: str) -> Dict[str, float]:
    """Run the reference eval driver on torch CPU; parse its results file."""
    import torch
    from PIL import Image
    from tqdm import tqdm

    _, ref_tok = _load_refoc()
    if args.driver == "clip":
        model, cfg = build_reference_model(args.model, args.checkpoint)
        process = _RefProcess(cfg.vision.image_size, ref_tok.SimpleTokenizer())
        eval_src = REF_EVAL_CLIP
    else:
        model, cfg = build_reference_pacl(args)
        process = _PaclRefProcess(cfg.vision.image_size,
                                  ref_tok.SimpleTokenizer())
        eval_src = REF_EVAL_PACL if args.driver == "pacl" else REF_EVAL_SPARC

    ns = {
        "torch": torch, "os": os, "json": json, "csv": __import__("csv"),
        "tqdm": tqdm, "Image": Image, "device": torch.device("cpu"),
        "model": model, "process": process,
    }
    load_reference_eval_fns(ns, eval_src)

    # signatures differ per driver: eval_clip's fns read the global model;
    # eval_pacl/eval_sparc pass it explicitly; eval_sparc adds the local flag
    extra = () if args.driver == "clip" else (model,)
    tail = (args.local,) if args.driver == "sparc" else ()

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        if args.dataset in ("mmvp", "mmvpvlm"):
            ns["eval_MMVP"](model, args.root_dir, args.dataset, *tail)
        else:
            dataset = json.load(open(_annotation_file(args)))
            if args.dataset in ("a", "b"):
                ns["eval"](*extra, dataset, args.root_dir, args.dataset,
                           *tail)
            elif args.dataset in ("a4", "b4"):
                ns["eval_4"](*extra, dataset, args.root_dir, args.dataset,
                             *tail)
            else:
                ns["eval_COCO_VG"](*extra, dataset, args.root_dir,
                                   args.dataset, *tail)
    finally:
        os.chdir(cwd)
    return parse_results_file(os.path.join(workdir,
                                           "evaluation_results.txt"))


def _annotation_file(args) -> str:
    names = {
        "a": "controlled_images_dataset.json",
        "a4": "controlled_images_dataset.json",
        "b": "controlled_clevr_dataset.json",
        "b4": "controlled_clevr_dataset.json",
        "cocoone": "coco_qa_one_obj.json",
        "cocotwo": "coco_qa_two_obj.json",
        "vgone": "vg_qa_one_obj.json",
        "vgtwo": "vg_qa_two_obj.json",
    }
    return os.path.join(args.root_dir, names[args.dataset])


def parse_results_file(path: str) -> Dict[str, float]:
    """'<metric>: <value>' lines -> {metric: float} (both drivers' format)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if ":" not in line:
                continue
            key, _, value = line.rpartition(":")
            key = key.strip()
            for part in value.replace(",", " ").split():
                try:
                    out[key] = float(part)
                    break
                except ValueError:
                    continue
            # 'Pair: X, Individual: Y' MMVP summary line
            if line.startswith("Pair:") and "Individual:" in line:
                bits = line.replace(",", "").split()
                out["Pair"] = float(bits[1])
                out["Individual"] = float(bits[3])
    return out


# -- JAX side -----------------------------------------------------------------


def run_jax_eval(args, workdir: str) -> Dict[str, float]:
    from . import eval as jax_eval

    results_file = os.path.join(workdir, "evaluation_results.txt")
    argv = [
        "--scorer", args.driver, "--model", args.model,
        "--dataset", args.dataset, "--root-dir", args.root_dir,
        "--results-file", results_file,
        "--precision", args.precision,
    ]
    if args.driver == "clip":
        argv += ["--pretrained", args.checkpoint]
    else:
        # split the DataParallel checkpoint: tower sub-dict -> a torch .pt
        # that feeds create_model(pretrained=...), heads -> flax .npz
        import torch

        from ..core.factory import save_params_npz
        from ..core.torch_convert import split_pacl_checkpoint

        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
        clip_sd, head_params = split_pacl_checkpoint(sd)
        tower_pt = os.path.join(workdir, "tower.pt")
        head_npz = os.path.join(workdir, "head.npz")
        torch.save(clip_sd, tower_pt)
        save_params_npz(head_params, head_npz)
        argv += ["--pretrained", tower_pt, "--model-path", head_npz,
                 "--rope", args.rope]
        if args.driver == "sparc" and args.local:
            argv += ["--sparc-local"]
    jax_eval.main(argv)
    return parse_results_file(results_file)


# -- diff ---------------------------------------------------------------------


def diff_tables(ref: Dict[str, float], jax_table: Dict[str, float],
                tol: float) -> Dict:
    shared = sorted(set(ref) & set(jax_table))
    rows = []
    ok = True
    for key in shared:
        delta = jax_table[key] - ref[key]
        match = abs(delta) <= tol
        ok = ok and match
        rows.append({"metric": key, "reference": ref[key], "jax": jax_table[key],
                     "delta": delta, "match": match})
    return {
        "metrics": rows,
        "only_reference": sorted(set(ref) - set(jax_table)),
        "only_jax": sorted(set(jax_table) - set(ref)),
        "parity": ok and bool(shared),
    }


def main(argv=None):
    args = parse_args(argv)
    with tempfile.TemporaryDirectory() as ref_dir, \
            tempfile.TemporaryDirectory() as jax_dir:
        ref = run_reference_driver(args, ref_dir)
        jax_table = run_jax_eval(args, jax_dir)
    report = diff_tables(ref, jax_table, args.tol)
    report["driver"] = args.driver
    report["dataset"] = args.dataset
    report["model"] = args.model
    report["checkpoint"] = args.checkpoint

    width = max((len(r["metric"]) for r in report["metrics"]), default=6)
    print(f"{'metric':<{width}}  {'reference':>10}  {'jax':>10}  {'delta':>10}")
    for r in report["metrics"]:
        flag = "" if r["match"] else "  <-- MISMATCH"
        print(f"{r['metric']:<{width}}  {r['reference']:>10.4f}  "
              f"{r['jax']:>10.4f}  {r['delta']:>10.4f}{flag}")
    print(f"parity: {report['parity']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)
