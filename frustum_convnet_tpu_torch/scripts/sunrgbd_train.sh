#!/bin/bash
# SUN-RGBD in the PyTorch port (the twin of scripts/sunrgbd_train.sh):
# train, then eval both from GT 2D boxes and from RGB detections.
# DEVICE=cpu runs on the CPU.
set -e
DEVICE=${DEVICE:-cuda}
python -m frustum_convnet_tpu_torch.engine.train --cfg cfgs/det_sample_sunrgbd.yaml --device "$DEVICE" OUTPUT_DIR output/sunrgbd_train
python -m frustum_convnet_tpu_torch.engine.test_sunrgbd --cfg cfgs/det_sample_sunrgbd.yaml --device "$DEVICE" \
    OUTPUT_DIR output/sunrgbd_train TEST.WEIGHTS output/sunrgbd_train/checkpoints/model_best.pth \
    FROM_RGB_DET False OVER_WRITE_TEST_FILE ''
python -m frustum_convnet_tpu_torch.engine.test_sunrgbd --cfg cfgs/det_sample_sunrgbd.yaml --device "$DEVICE" \
    OUTPUT_DIR output/sunrgbd_train TEST.WEIGHTS output/sunrgbd_train/checkpoints/model_best.pth \
    FROM_RGB_DET True
