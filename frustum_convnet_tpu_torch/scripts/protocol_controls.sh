#!/bin/bash
# The port's protocol controls on one card, one leg a command:
#
#   bash frustum_convnet_tpu_torch/scripts/protocol_controls.sh OUT_DIR CACHE_DIR stage1 [FROM_DIR]
#   bash frustum_convnet_tpu_torch/scripts/protocol_controls.sh OUT_DIR CACHE_DIR refine STAGE1_DIR
#
# stage1: the stage-1 protocol (cfgs/det_sample.yaml verbatim, 2000
# synthetic frames, TRAIN.SEED 4: the JAX round-5 control row) through
# run_synth_protocol, to EPOCHS. With FROM_DIR (the OUT_DIR/stage1_<tag> of
# an earlier leg that stopped short of 50 epochs) it restores that leg's
# checkpoints and train.log and resumes (RESUME True): the LR schedule is
# periodic in the epoch and the loader is seeded by the epoch, so a run can
# be cut into legs that each fit a time limit.
# refine: the refine protocol (cfgs/refine_car.yaml, model_final) through
# run_refine_protocol, on the val results of STAGE1_DIR (an earlier stage-1
# leg's OUT_DIR/stage1_<tag>).
#
# Each leg copies protocol_result.json, train.log, the test log and
# val_nms/result/data to OUT_DIR/<run>; a stage-1 leg short of 50 epochs
# also model_final.pth and model_best.pth's weights (53 MB), for the next
# leg. The dataset stays in CACHE_DIR and is regenerated, identical, by a
# leg that does not find it.
#
# Environment: DTYPE (float32), EPOCHS (50).
set -euo pipefail
OUT=${1:?usage: protocol_controls.sh OUT_DIR CACHE_DIR stage1|refine [FROM_DIR]}
CACHE=${2:?usage: protocol_controls.sh OUT_DIR CACHE_DIR stage1|refine [FROM_DIR]}
STAGE=${3:?usage: protocol_controls.sh OUT_DIR CACHE_DIR stage1|refine [FROM_DIR]}
FROM=${4:-}
DTYPE=${DTYPE:-float32}
EPOCHS=${EPOCHS:-50}
SEED=4
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

S1_TAG="${DTYPE}_s${SEED}"
S1_RUN="$CACHE/run_$S1_TAG"
case "$STAGE" in
stage1)
    RESUME_ARGS=()
    if [ -n "$FROM" ]; then
        mkdir -p "$S1_RUN/checkpoints"
        cp "$FROM/model_final.pth" "$FROM/model_best.pth" "$S1_RUN/checkpoints/"
        cp "$FROM/train.log" "$S1_RUN/train.log"
        RESUME_ARGS=(--override RESUME True)
    fi
    python3 -m frustum_convnet_tpu_torch.tools.run_synth_protocol --dtype "$DTYPE" \
        --epochs "$EPOCHS" --cache "$CACHE" --workers "$WORKERS" --tag "$S1_TAG" \
        --override TRAIN.SEED "$SEED" "${RESUME_ARGS[@]}" 2>&1 | tee "$OUT/stage1.log"
    keep "$S1_RUN" "stage1_$S1_TAG" "$([ "$EPOCHS" -lt 50 ] && echo checkpoints)"
    ;;
refine)
    mkdir -p "$S1_RUN/val_nms/result"
    rm -rf "$S1_RUN/val_nms/result/data"
    cp -r "${FROM:?refine needs STAGE1_DIR}/data" "$S1_RUN/val_nms/result/data"
    R_TAG="refine_${DTYPE}_from_${S1_TAG}"
    python3 -m frustum_convnet_tpu_torch.tools.run_refine_protocol --dtype "$DTYPE" \
        --epochs "$EPOCHS" --cache "$CACHE" --workers "$WORKERS" --stage1 "$S1_RUN" \
        --tag "$R_TAG" 2>&1 | tee "$OUT/refine.log"
    keep "$CACHE/run_$R_TAG" "$R_TAG"
    ;;
*)
    echo "unknown stage $STAGE (stage1 or refine)" >&2
    exit 2
    ;;
esac
