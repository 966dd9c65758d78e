#!/bin/bash
# KITTI Pedestrian+Cyclist pipeline in the PyTorch port, on one card: stage 1
# + refinement (the twin of scripts/people_all.sh). Stage 1 serves
# model_best.pth; the refine stage serves model_final.pth, as car_all.sh.
# DEVICE=cpu runs the trainer and the driver on the CPU.
set -e
DATA_ROOT=${DATA_ROOT:-data/kitti}
DEVICE=${DEVICE:-cuda}

python -m frustum_convnet_tpu_torch.data.kitti.prepare --people_only --gen_train --gen_val --gen_val_rgb_detection --data_root "$DATA_ROOT"

python -m frustum_convnet_tpu_torch.engine.train --cfg cfgs/det_sample_people.yaml --device "$DEVICE" OUTPUT_DIR output/people_train
python -m frustum_convnet_tpu_torch.engine.test --cfg cfgs/det_sample_people.yaml --device "$DEVICE" \
    --gt_dir "$DATA_ROOT/training/label_2" --idx_path "$DATA_ROOT/image_sets/val.txt" \
    OUTPUT_DIR output/people_train TEST.WEIGHTS output/people_train/checkpoints/model_best.pth

# --gen_val as well: the refine trainer's validation epoch reads the labeled
# val pickle
python -m frustum_convnet_tpu_torch.data.kitti.prepare_refine --people_only --gen_train --gen_val --gen_val_rgb_detection \
    --data_root "$DATA_ROOT" --val_res_dir output/people_train/val_nms/result/data

python -m frustum_convnet_tpu_torch.engine.train --cfg cfgs/refine_people.yaml --device "$DEVICE" OUTPUT_DIR output/people_train_refine
python -m frustum_convnet_tpu_torch.engine.test --cfg cfgs/refine_people.yaml --device "$DEVICE" \
    --gt_dir "$DATA_ROOT/training/label_2" --idx_path "$DATA_ROOT/image_sets/val.txt" \
    OUTPUT_DIR output/people_train_refine TEST.WEIGHTS output/people_train_refine/checkpoints/model_final.pth
