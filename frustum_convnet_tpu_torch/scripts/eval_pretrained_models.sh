#!/bin/bash
# Evaluate existing checkpoints in the PyTorch port (the twin of
# scripts/eval_pretrained_models.sh), demonstrating the two-stage chaining
# via OVER_WRITE_TEST_FILE (the stage-1 result dir feeds refine prep, whose
# pickle feeds the refine test pass). The checkpoints are .pth files: the
# port's own or the reference's. DEVICE=cpu serves on the CPU.
set -e
DATA_ROOT=${DATA_ROOT:-data/kitti}
DEVICE=${DEVICE:-cuda}
STAGE1_CKPT=${1:?usage: eval_pretrained_models.sh <stage1.pth> <refine.pth>}
REFINE_CKPT=${2:?}

python -m frustum_convnet_tpu_torch.engine.test --cfg cfgs/det_sample.yaml --device "$DEVICE" \
    --gt_dir "$DATA_ROOT/training/label_2" --idx_path "$DATA_ROOT/image_sets/val.txt" \
    OUTPUT_DIR output/eval_stage1 TEST.WEIGHTS "$STAGE1_CKPT"

python -m frustum_convnet_tpu_torch.data.kitti.prepare_refine --car_only --gen_val_rgb_detection \
    --data_root "$DATA_ROOT" --val_res_dir output/eval_stage1/val_nms/result/data \
    --save_dir output/eval_stage1/pickle_data_refine

python -m frustum_convnet_tpu_torch.engine.test --cfg cfgs/refine_car.yaml --device "$DEVICE" \
    --gt_dir "$DATA_ROOT/training/label_2" --idx_path "$DATA_ROOT/image_sets/val.txt" \
    OUTPUT_DIR output/eval_refine TEST.WEIGHTS "$REFINE_CKPT" \
    OVER_WRITE_TEST_FILE output/eval_stage1/pickle_data_refine/frustum_caronly_val_rgb_detection.pickle
