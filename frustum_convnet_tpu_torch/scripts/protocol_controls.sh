#!/bin/bash
# The port's protocol controls on one card, one leg a command:
#
#   bash frustum_convnet_tpu_torch/scripts/protocol_controls.sh OUT_DIR CACHE_DIR stage1 [FROM_DIR]
#   bash frustum_convnet_tpu_torch/scripts/protocol_controls.sh OUT_DIR CACHE_DIR refine STAGE1_DIR
#
# stage1: the stage-1 protocol (cfgs/det_sample.yaml verbatim, 2000
# synthetic frames, TRAIN.SEED 4: the JAX round-5 control seed) through
# run_synth_protocol, at RECIPE, to EPOCHS. With FROM_DIR (the OUT_DIR/stage1_<tag> of
# an earlier leg that stopped short of 50 epochs) it restores that leg's
# checkpoints and train.log and resumes (RESUME True): the LR schedule is
# periodic in the epoch and the loader is seeded by the epoch, so a run can
# be cut into legs that each fit a time limit.
# refine: the refine protocol (cfgs/refine_car.yaml, model_final) through
# run_refine_protocol, on the val results of STAGE1_DIR (an earlier stage-1
# leg's OUT_DIR/stage1_<tag>), at RECIPE's dtype and overrides. Its run
# takes the stage-1 tag of STAGE1_DIR.
#
# Each leg copies protocol_result.json, train.log, the test log and
# val_nms/result/data to OUT_DIR/<run>; a stage-1 leg short of 50 epochs
# also model_final.pth and model_best.pth's weights (53 MB), for the next
# leg. The dataset stays in CACHE_DIR and is regenerated, identical, by a
# leg that does not find it.
#
# Environment: EPOCHS (50); MIX=1 passes --difficulty_mix (stage 1 only);
# RECIPE, one of the JAX package's supported training recipes (bench.py,
# SUPPORTED_TRAIN_RECIPES), each with its own run tag:
#   f32_b32        float32, batch 32, lr 1e-3 (the default)
#   bf16_b32       bfloat16, batch 32, lr 1e-3
#   f32_b128       float32, batch 128, lr 4e-3
#   f16_b128_ft40  float16, batch 128, lr 4e-3, float32 for the last 40 epochs
set -euo pipefail
OUT=${1:?usage: protocol_controls.sh OUT_DIR CACHE_DIR stage1|refine [FROM_DIR]}
CACHE=${2:?usage: protocol_controls.sh OUT_DIR CACHE_DIR stage1|refine [FROM_DIR]}
STAGE=${3:?usage: protocol_controls.sh OUT_DIR CACHE_DIR stage1|refine [FROM_DIR]}
FROM=${4:-}
RECIPE=${RECIPE:-f32_b32}
EPOCHS=${EPOCHS:-50}
MIX=${MIX:-0}
SEED=4
B128=(--override TRAIN.BATCH_SIZE 128 --override TRAIN.BASE_LR 0.004)
case "$RECIPE" in
f32_b32) DTYPE=float32; RECIPE_ARGS=() ;;
bf16_b32) DTYPE=bfloat16; RECIPE_ARGS=() ;;
f32_b128) DTYPE=float32; RECIPE_ARGS=("${B128[@]}") ;;
f16_b128_ft40)
    DTYPE=float16
    FT_EPOCHS=40  # float32 for the last 40 of the 50 epochs
    # TPU.F32_FINETUNE_EPOCHS counts back from the leg's TRAIN.MAX_EPOCH: a
    # leg that stops at epoch EPOCHS takes what is left of FT_EPOCHS after
    # the 50 - EPOCHS epochs it does not run, so the switch stays at epoch 10
    FT=$((FT_EPOCHS - (50 - EPOCHS)))
    RECIPE_ARGS=("${B128[@]}" --override TPU.F32_FINETUNE_EPOCHS "$((FT > 0 ? FT : 0))")
    ;;
*)
    echo "unknown RECIPE $RECIPE (f32_b32, bf16_b32, f32_b128 or f16_b128_ft40)" >&2
    exit 2
    ;;
esac
MIX_ARGS=()
MIX_TAG=""
if [ "$MIX" = 1 ]; then
    MIX_ARGS=(--difficulty_mix)
    MIX_TAG="_mix"
fi
WORKERS=8  # prep processes
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt" || true

keep() {  # keep RUN_DIR NAME [checkpoints]: the small outputs of one run
    local dst="$OUT/$2"
    mkdir -p "$dst"
    cp "$1/protocol_result.json" "$1/train.log" "$dst/"
    cp "$1/val_nms/result/test.log" "$dst/test.log"
    cp -r "$1/val_nms/result/data" "$dst/data"
    if [ "${3:-}" = checkpoints ]; then
        cp "$1/checkpoints/model_final.pth" "$dst/"
        python3 -c 'import sys, torch
p = torch.load(sys.argv[1], map_location="cpu", weights_only=True)
torch.save({k: v for k, v in p.items() if k != "optimizer"}, sys.argv[2])' \
            "$1/checkpoints/model_best.pth" "$dst/model_best.pth"
    fi
}

case "$STAGE" in
stage1)
    S1_TAG="${RECIPE}${MIX_TAG}_s${SEED}"
    S1_RUN="$CACHE/run_$S1_TAG"
    RESUME_ARGS=()
    if [ -n "$FROM" ]; then
        mkdir -p "$S1_RUN/checkpoints"
        cp "$FROM/model_final.pth" "$FROM/model_best.pth" "$S1_RUN/checkpoints/"
        cp "$FROM/train.log" "$S1_RUN/train.log"
        RESUME_ARGS=(--override RESUME True)
    fi
    python3 -m frustum_convnet_tpu_torch.tools.run_synth_protocol --dtype "$DTYPE" \
        --epochs "$EPOCHS" --cache "$CACHE" --workers "$WORKERS" --tag "$S1_TAG" \
        "${MIX_ARGS[@]}" --override TRAIN.SEED "$SEED" "${RECIPE_ARGS[@]}" \
        "${RESUME_ARGS[@]}" 2>&1 | tee "$OUT/stage1.log"
    keep "$S1_RUN" "stage1_$S1_TAG" "$([ "$EPOCHS" -lt 50 ] && echo checkpoints)"
    ;;
refine)
    if [ "$MIX" = 1 ]; then
        echo "the refine protocol runs on proto-v1 only (MIX=1 is for stage1)" >&2
        exit 2
    fi
    S1_TAG=$(basename "${FROM:?refine needs STAGE1_DIR}")
    S1_TAG=${S1_TAG#stage1_}
    S1_RUN="$CACHE/run_$S1_TAG"
    mkdir -p "$S1_RUN/val_nms/result"
    rm -rf "$S1_RUN/val_nms/result/data"
    cp -r "$FROM/data" "$S1_RUN/val_nms/result/data"
    R_TAG="refine_${RECIPE}_from_${S1_TAG}"
    python3 -m frustum_convnet_tpu_torch.tools.run_refine_protocol --dtype "$DTYPE" \
        --epochs "$EPOCHS" --cache "$CACHE" --workers "$WORKERS" --stage1 "$S1_RUN" \
        --tag "$R_TAG" "${RECIPE_ARGS[@]}" 2>&1 | tee "$OUT/refine.log"
    keep "$CACHE/run_$R_TAG" "$R_TAG"
    ;;
*)
    echo "unknown stage $STAGE (stage1 or refine)" >&2
    exit 2
    ;;
esac
