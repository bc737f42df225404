#!/usr/bin/env bash
# Full evaluation matrix, mirroring the reference driver loop
# (Patch-Aligned-Contrastive-Learning/eval.sh: What'sUp A/B + 4-option,
# COCO/VG one/two-object, MMVP, MMVP-VLM for one scorer family).
#
# Usage:
#   WHATSUP_ROOT=/data/whatsup COCO_VG_ROOT=/data/whatsup MMVP_ROOT=/data/mmvp \
#       scripts/eval_matrix.sh [scorer] [model] [checkpoint]
#
# scorer in {clip, siglip, pacl, sparc, embedding}; results append to
# evaluation_results.txt like the reference.
set -euo pipefail

SCORER=${1:-clip}
MODEL=${2:-ViT-L-14-336}
CKPT=${3:-}
WHATSUP_ROOT=${WHATSUP_ROOT:?set WHATSUP_ROOT}
COCO_VG_ROOT=${COCO_VG_ROOT:-$WHATSUP_ROOT}
MMVP_ROOT=${MMVP_ROOT:-$WHATSUP_ROOT}

run() {
  local ds=$1 root=$2
  echo "== $SCORER / $MODEL / $ds"
  python -m clip_embeds.cli.eval \
      --scorer "$SCORER" --model "$MODEL" \
      ${CKPT:+--pretrained "$CKPT"} \
      --dataset "$ds" --root-dir "$root"
}

for ds in a b a4 b4; do run "$ds" "$WHATSUP_ROOT"; done
for ds in cocoone cocotwo vgone vgtwo; do run "$ds" "$COCO_VG_ROOT"; done
for ds in mmvp mmvpvlm; do run "$ds" "$MMVP_ROOT"; done
