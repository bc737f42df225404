"""End-to-end accuracy-parity runbook proof on tiny fixtures.

cli/parity.py runs the ACTUAL reference eval functions (eval_clip.py,
AST-extracted and executed with the reference open_clip torch model from the
reference checkout) and the repo's JAX eval on the same checkpoint + dataset,
then diffs the accuracy tables. Here both run on a random tiny checkpoint
over a synthetic What'sUp fixture — with real weights and the real dataset
the same command fills BASELINE.md's parity column.
"""

import json

import numpy as np
import pytest
from PIL import Image

pytestmark = pytest.mark.slow  # runs the reference torch driver end to end


@pytest.fixture()
def whatsup_fixture(tmp_path):
    """Synthetic What'sUp-A-format dataset: n object pairs x 4 images."""
    root = tmp_path / "whatsup"
    img_dir = root / "controlled_images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    dataset = []
    for p in range(3):
        o1, o2 = f"mug{p}", f"table{p}"
        for key in ["left", "right", "on", "under"]:
            name = f"{o1}_{key}_of_the_{o2}.jpeg"
            arr = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(img_dir / name)
            prep = {"left": "left of", "right": "right of",
                    "on": "on", "under": "under"}[key]
            opp = {"left": "right of", "right": "left of",
                   "on": "under", "under": "on"}[key]
            others = {"left of", "right of", "on", "under"} - {prep, opp}
            gt = f"A {o1} {prep} a {o2}"
            dataset.append({
                "image_path": f"data/controlled_images/{name}",
                "caption_options": [gt, f"A {o1} {opp} a {o2}"]
                + [f"A {o1} {o} a {o2}" for o in sorted(others)],
            })
    with open(root / "controlled_images_dataset.json", "w") as f:
        json.dump(dataset, f)
    return root


@pytest.fixture()
def tiny_checkpoint(tmp_path):
    """Random reference torch test-tiny CLIP saved as a .pt checkpoint."""
    torch = pytest.importorskip("torch")

    from clip_embeds.cli.parity import _load_refoc
    from clip_embeds.core.config import get_model_config

    refoc_model, _ = _load_refoc()
    cfg = get_model_config("test-tiny")
    torch.manual_seed(0)
    model = refoc_model.CLIP(
        embed_dim=cfg.embed_dim,
        vision_cfg=dict(
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
            width=cfg.vision.width, layers=cfg.vision.layers,
            head_width=cfg.vision.head_width,
        ),
        text_cfg=dict(
            context_length=cfg.text.context_length,
            vocab_size=cfg.text.vocab_size, width=cfg.text.width,
            heads=cfg.text.heads, layers=cfg.text.layers,
        ),
    )
    path = tmp_path / "test-tiny.pt"
    torch.save(model.state_dict(), str(path))
    return str(path)


def test_parity_runbook_whatsup(whatsup_fixture, tiny_checkpoint, tmp_path):
    from clip_embeds.cli.parity import main

    out = tmp_path / "report.json"
    report = main([
        "--model", "test-tiny", "--checkpoint", tiny_checkpoint,
        "--dataset", "a", "--root-dir", str(whatsup_fixture),
        "--precision", "fp32", "--tol", "1e-4", "--out", str(out),
    ])
    assert report["metrics"], "no shared metrics parsed"
    names = {r["metric"] for r in report["metrics"]}
    assert "Individual accuracy" in names
    assert "Pair accuracy" in names and "Set accuracy" in names
    assert report["parity"] is True, report
    assert json.load(open(out))["parity"] is True


def test_results_file_parser(tmp_path):
    from clip_embeds.cli.parity import parse_results_file

    path = tmp_path / "r.txt"
    path.write_text(
        "Model path: x Dataset: a\n"
        "Individual accuracy: 54.13\n"
        "Pair accuracy: 9.22\n"
        "Pair: 12.5, Individual: 40.0\n"
    )
    parsed = parse_results_file(str(path))
    assert parsed["Individual accuracy"] == 54.13
    assert parsed["Pair accuracy"] == 9.22
    assert parsed["Pair"] == 12.5 and parsed["Individual"] == 40.0


@pytest.fixture()
def whatsup_fixture_64(tmp_path):
    """What'sUp-A fixture with square 64px images (the PACL squash-resize
    becomes an identity on both drivers, removing resample-kernel noise)."""
    root = tmp_path / "whatsup64"
    img_dir = root / "controlled_images"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    dataset = []
    for p in range(3):
        o1, o2 = f"cup{p}", f"desk{p}"
        for key in ["left", "right", "on", "under"]:
            name = f"{o1}_{key}_of_the_{o2}.jpeg"
            arr = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
            Image.fromarray(arr).save(img_dir / name)
            prep = {"left": "left of", "right": "right of",
                    "on": "on", "under": "under"}[key]
            opp = {"left": "right of", "right": "left of",
                   "on": "under", "under": "on"}[key]
            others = {"left of", "right of", "on", "under"} - {prep, opp}
            dataset.append({
                "image_path": f"data/controlled_images/{name}",
                "caption_options": [f"A {o1} {prep} a {o2}",
                                    f"A {o1} {opp} a {o2}"]
                + [f"A {o1} {o} a {o2}" for o in sorted(others)],
            })
    with open(root / "controlled_images_dataset.json", "w") as f:
        json.dump(dataset, f)
    return root


def _tiny_pacl_checkpoint(tmp_path, driver: str, seed: int = 0):
    """Random reference PACL/SPARC model (the ACTUAL reference classes from
    model/pacl.py, instantiated around the test-pacl-tiny tower) saved in the
    DataParallel 'module.'-prefixed format of train_pacl.py:133."""
    torch = pytest.importorskip("torch")

    from clip_embeds.cli.parity import _load_ref_pacl_ns

    ns = _load_ref_pacl_ns("test-pacl-tiny")
    torch.manual_seed(seed)
    cls = ns["open_clip_pacl"] if driver == "pacl" else ns["sparc"]
    model = cls(base_model="ViT-L-14-336")
    sd = {"module." + k: v for k, v in model.state_dict().items()}
    path = tmp_path / f"{driver}_tiny.pth"
    torch.save(sd, str(path))
    return str(path)


@pytest.mark.parametrize("driver,local", [
    ("pacl", False), ("sparc", False), ("sparc", True),
])
def test_parity_runbook_pacl_sparc(whatsup_fixture_64, tmp_path, driver,
                                   local):
    from clip_embeds.cli.parity import main

    ckpt = _tiny_pacl_checkpoint(tmp_path, driver)
    argv = [
        "--driver", driver, "--model", "test-pacl-tiny",
        "--checkpoint", ckpt, "--dataset", "a",
        "--root-dir", str(whatsup_fixture_64),
        "--precision", "fp32", "--tol", "1e-4",
    ]
    if local:
        argv.append("--local")
    report = main(argv)
    assert report["metrics"], "no shared metrics parsed"
    names = {r["metric"] for r in report["metrics"]}
    assert "Individual accuracy" in names
    assert report["parity"] is True, report
