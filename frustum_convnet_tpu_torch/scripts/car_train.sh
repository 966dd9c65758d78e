#!/bin/bash
# Train the KITTI Car stage-1 model in the PyTorch port (the twin of
# scripts/car_train.sh). DEVICE=cpu trains on the CPU.
set -e
DEVICE=${DEVICE:-cuda}
python -m frustum_convnet_tpu_torch.engine.train --cfg cfgs/det_sample.yaml --device "$DEVICE" OUTPUT_DIR output/car_train "$@"
