"""frustum_convnet_tpu_torch — the PyTorch/CUDA port of ``frustum_convnet_tpu``.

The JAX package is the reference; this package mirrors its module layout
where a counterpart exists (``core/{codecs,geometry,iou}``,
``ops/query_depth_point``, ``models/{net,det,losses}``,
``parallel/train_step``, ``engine/{train,test,checkpoints}``,
``tools/profile_stages``) and imports every jax-free shared module of it as
it is: ``configs/``, ``data/``, ``engine/loader``, ``evaluation/``,
``models/spec`` with ``models.registry.get_model_spec``, ``ops/native`` and
``utils/``.

The port never imports ``jax``, ``flax`` or ``optax``. Its hand-written
kernels, the depth-window grouping op in three modes (every scale in one
launch, one scale, the select alone), are CUDA C++ for Hopper
(``csrc/group_depth_point.cu``), built with ``nvcc`` at first use and bound
with ``ctypes`` (``ops/_build.py``, ``ops/select_cuda.py``).
"""

__version__ = "0.1.0"
