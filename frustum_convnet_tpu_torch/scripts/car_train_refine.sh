#!/bin/bash
# Train the KITTI Car refine stage in the PyTorch port (the twin of
# scripts/car_train_refine.sh). DEVICE=cpu trains on the CPU.
set -e
DEVICE=${DEVICE:-cuda}
python -m frustum_convnet_tpu_torch.engine.train --cfg cfgs/refine_car.yaml --device "$DEVICE" OUTPUT_DIR output/car_train_refine "$@"
