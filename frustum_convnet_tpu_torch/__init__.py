"""frustum_convnet_tpu_torch — the PyTorch/CUDA port of ``frustum_convnet_tpu``.

The JAX package is the reference; this package mirrors its module layout
and imports nothing of it. The modules that needed jax are rewritten in
PyTorch (``core/{codecs,geometry,iou}``, ``ops/query_depth_point``,
``models/{net,det,losses}``, ``parallel/train_step``,
``engine/{train,test,test_sunrgbd,checkpoints}``, ``tools/profile_stages``).
The jax-free ones are copied under the same relative paths, with only their
imports pointed at this package: ``configs/{config,attrdict}``,
``core/{geometry_np,iou_np,nms,box_overlaps}``, ``data/{dataset_info,
pickle_io,prep_util,provider,provider_refine,provider_sunrgbd,fixtures,
registry}``, ``data/kitti/{calib,object,synthetic,prepare,prepare_refine}``,
``data/sunrgbd/{calib,object,synthetic,prepare,ingest}``, ``engine/loader``,
``evaluation/{kitti_writer,kitti_eval,plots,sunrgbd_eval}``,
``models/{spec,registry}``, ``ops/native`` and ``utils/{logger,tfevents,
metrics}``. ``ops/native`` builds the repository's host C++ library and
evaluator (``native/``, ``make -C native`` into ``native/build/``) at first
use and falls back to numpy where that fails.

The port never imports ``jax``, ``flax`` or ``optax``. Its hand-written
kernels, the depth-window grouping op in three modes (every scale in one
launch, one scale, the select alone), are CUDA C++ for Hopper
(``csrc/group_depth_point.cu``), built with ``nvcc`` at first use and bound
with ``ctypes`` (``ops/_build.py``, ``ops/select_cuda.py``).
"""

__version__ = "0.1.0"
