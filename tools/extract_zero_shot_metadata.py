"""Extract IMAGENET_CLASSNAMES + the 80 OpenAI prompt templates as data.

Source: reference open_clip/src/open_clip/zero_shot_metadata.py (the public
OpenAI CLIP prompt/classname lists). Templates are `lambda c: f"..."`
expressions there; we AST-convert each f-string into a plain "{c}" format
string so the data file carries no code. Output:
clip_embeds/evals/zero_shot_metadata.json

Run: python tools/extract_zero_shot_metadata.py
"""

from __future__ import annotations

import ast
import json
import os

REF = "/root/reference/open_clip/src/open_clip/zero_shot_metadata.py"
OUT = os.path.join(
    os.path.dirname(__file__), "..",
    "clip_embeds", "evals", "zero_shot_metadata.json",
)


def _fstring_to_format(node: ast.Lambda) -> str:
    body = node.body
    assert isinstance(body, ast.JoinedStr), ast.dump(body)[:80]
    parts = []
    for v in body.values:
        if isinstance(v, ast.Constant):
            parts.append(str(v.value))
        elif isinstance(v, ast.FormattedValue):
            assert isinstance(v.value, ast.Name) and v.value.id == "c"
            parts.append("{c}")
        else:
            raise AssertionError(ast.dump(v))
    return "".join(parts)


def main() -> None:
    with open(REF) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        name = node.targets[0].id  # type: ignore[attr-defined]
        if name in ("OPENAI_IMAGENET_TEMPLATES", "SIMPLE_IMAGENET_TEMPLATES"):
            out[name] = [_fstring_to_format(el) for el in node.value.elts]
        elif name == "IMAGENET_CLASSNAMES":
            out[name] = [ast.literal_eval(el) for el in node.value.elts]
    assert len(out.get("IMAGENET_CLASSNAMES", [])) == 1000
    assert len(out.get("OPENAI_IMAGENET_TEMPLATES", [])) == 80
    with open(os.path.abspath(OUT), "w") as fh:
        json.dump(out, fh, indent=0)
        fh.write("\n")
    print({k: len(v) for k, v in out.items()}, "->", OUT)


if __name__ == "__main__":
    main()
