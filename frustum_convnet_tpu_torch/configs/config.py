"""Global configuration tree for frustum_convnet_tpu.

Key set and default values replicate the reference config system
(reference `configs/config.py:63-192`) so that the reference's yaml
experiment files (`cfgs/*.yaml`) are accepted verbatim. Two deliberate
departures from the reference:

* ``MODEL.FILE`` / ``DATA.FILE`` are *registry names* here, not python file
  paths that get dynamically imported (reference `utils/utils.py:12-25`).
  For compatibility, reference file paths like ``models/det_base.py`` are
  mapped to registry names by :data:`MODEL_FILE_ALIASES` /
  :data:`DATA_FILE_ALIASES`.
* Extra TPU-specific keys live under ``cfg.TPU`` (mesh shape, dtypes, host
  pipeline) and have no counterpart in the reference.

Fresh implementation (Detectron-style merge with type coercion, then frozen).
"""

from __future__ import annotations

import ast
import copy
import os

import numpy as np
import yaml

from frustum_convnet_tpu_torch.configs.attrdict import AttrDict

# Map the reference's code-path-valued config entries to registry names.
MODEL_FILE_ALIASES = {
    "models/det_base.py": "det_base",
    "models/det_base_sunrgbd.py": "det_base_sunrgbd",
}
DATA_FILE_ALIASES = {
    "datasets/provider_sample.py": "provider_sample",
    "datasets/provider_sample_refine.py": "provider_sample_refine",
    "datasets/provider_sample_sunrgbd.py": "provider_sample_sunrgbd",
}


def _build_default_cfg() -> AttrDict:
    C = AttrDict()

    # ---- Training options (ref configs/config.py:63-90) ----
    C.TRAIN = AttrDict()
    C.TRAIN.WEIGHTS = ""
    C.TRAIN.BATCH_SIZE = 32
    C.TRAIN.START_EPOCH = 0
    C.TRAIN.MAX_EPOCH = 200
    C.TRAIN.OPTIMIZER = "adam"  # adam | sgd
    C.TRAIN.BASE_LR = 0.001
    C.TRAIN.MIN_LR = 1e-5
    C.TRAIN.LR_POLICY = "step"
    C.TRAIN.GAMMA = 0.1
    C.TRAIN.LR_STEPS = [20]
    # linear LR warmup epochs (fractional ok; 0 = reference schedule).
    # Rebuild-only: the large-batch stabilizer for LR-scaled recipes.
    C.TRAIN.WARMUP_EPOCHS = 0.0
    C.TRAIN.MOMENTUM = 0.9
    C.TRAIN.WEIGHT_DECAY = 0.0
    C.TRAIN.DATASET = "train"  # train | val | trainval
    # Rebuild-only: training RNG seed (param init + shuffle + augmentation).
    # The reference hardcodes seed 3 (`train/train_net_det.py:64-68,247`);
    # varying this measures run-to-run AP spread (the protocol noise floor).
    # Offline data prep keeps its own fixed seed 3.
    C.TRAIN.SEED = 3

    # ---- Model options (ref :94-98) ----
    C.MODEL = AttrDict()
    C.MODEL.FILE = ""  # registry name or reference file path alias
    C.MODEL.NUM_CLASSES = 2

    # ---- Test options (ref :102-115) ----
    C.TEST = AttrDict()
    C.TEST.WEIGHTS = ""
    C.TEST.BATCH_SIZE = 32
    C.TEST.METHOD = "top"  # nms | top
    C.TEST.THRESH = 0.1  # NMS overlap threshold
    C.TEST.DATASET = "val"  # val | test

    # ---- Data options (ref :120-155) ----
    C.DATA = AttrDict()
    C.DATA.DATASET_NAME = "KITTI"  # KITTI | SUNRGBD
    C.DATA.MAX_DEPTH = 70
    C.DATA.FILE = ""  # registry name or reference file path alias
    C.DATA.DATA_ROOT = "kitti"
    C.DATA.WITH_EXTRA_FEAT = True  # intensity for KITTI, rgb for SUN-RGBD
    C.DATA.EXTRA_FEAT_DIM = 1
    C.DATA.NUM_SAMPLES = 1024
    C.DATA.NUM_SAMPLES_DET = 512
    C.DATA.CAR_ONLY = True
    C.DATA.PEOPLE_ONLY = False
    C.DATA.RTC = True  # rotate frustum to center view
    C.DATA.NUM_HEADING_BIN = 12
    C.DATA.STRIDE = (0.25, 0.5, 1.0, 2.0)  # sliding-frustum strides per scale
    C.DATA.HEIGHT_HALF = (0.25, 0.5, 1.0, 2.0)  # depth half-window per scale
    C.DATA.EXTEND_FROM_DET = False
    # TPU-only: static section-ladder span (meters) for the refine provider.
    # The reference pads refine ref counts per batch (dynamic shapes,
    # `provider_sample_refine.py:388-419`); a fixed span keeps shapes static.
    C.DATA.REFINE_MAX_SPAN = 6.4

    # ---- Loss options (ref :159-167) ----
    C.LOSS = AttrDict()
    C.LOSS.BOX_LOSS_WEIGHT = 1.0
    C.LOSS.CORNER_LOSS_WEIGHT = 10.0
    C.LOSS.HEAD_REG_WEIGHT = 20.0
    C.LOSS.SIZE_REG_WEIGHT = 20.0

    # ---- Misc (ref :171-192) ----
    C.RESUME = False
    C.NUM_GPUS = 1  # kept for yaml compatibility; ignored (mesh rules)
    C.OUTPUT_DIR = "/tmp"
    C.SAVE_SUB_DIR = "test"
    C.OVER_WRITE_TEST_FILE = ""
    C.FROM_RGB_DET = False
    C.NUM_WORKERS = 4
    C.USE_TFBOARD = False
    C.EVAL_MODE = False
    C.IOU_THRESH = 0.7  # car 0.7, people 0.5, sunrgbd 0.25
    C.disp = 50

    # ---- TPU-native options (no reference counterpart) ----
    C.TPU = AttrDict()
    C.TPU.MESH_SHAPE = [-1]  # data-parallel axis; -1 = all devices
    C.TPU.MESH_AXES = ["data"]
    # Train compute dtype: float32 | bfloat16 | float16. Params, BN
    # statistics, and optimizer state stay float32 in every mode. bfloat16
    # halves the (B, M, K, C) activation bandwidth that floors the step
    # (18.5 -> 11.45 ms at batch 32; 64.4 -> 36.4 ms at batch 128) and is
    # AP-validated at the reference batch 32 (90.45, in band — the
    # supported training-throughput headline, 13.5x); every bf16
    # *scaled-batch* recipe measured out of the AP band (BENCH_NOTES
    # "bf16 scaled-batch AP campaign" + ghost-BN section). float16 keeps
    # the same bandwidth win with 8x finer mantissa — the weight-gradient
    # overflow hazard is guarded by models/net's f32-dW dense dot in the
    # PointNet MLPs (where the reduction spans B*M*K ~ millions of rows and
    # plain f16 overflows instantly) and in the cls/reg heads; the trunk
    # convs still run stock f16 (their dW reductions are ~64x smaller and
    # have stayed finite through every protocol run up to batch 128), and
    # the train loop now aborts loudly on a non-finite loss instead of
    # diverging silently. Supported at scaled batch via the
    # F32_FINETUNE_EPOCHS schedule below (BENCH_NOTES "float16 compute").
    C.TPU.COMPUTE_DTYPE = "float32"
    # optional separate dtype for the conv trunk + heads ("" = follow the
    # compute dtype). "float32" under COMPUTE_DTYPE=bfloat16 keeps the bf16
    # step speedup (36.7 ms vs pure bf16's 36.4 ms at batch 128) BUT its
    # 50-epoch protocol run measured Car 3D AP 76.4 at batch 128/lr 4e-3 —
    # 13 AP below even pure bf16, heading collapse — so it is NOT a
    # supported training recipe (BENCH_NOTES "Mixed-stage precision"). The
    # mechanism is kept for experimentation only.
    C.TPU.TRUNK_DTYPE = ""
    # inference compute dtype (params stay f32). bfloat16 measured perf-neutral
    # on v5e for this model (the Pallas grouping kernel dominates, BENCH_NOTES),
    # so the default keeps float32 numerics.
    C.TPU.INFER_DTYPE = "float32"
    C.TPU.PREFETCH = 2  # host pipeline prefetch depth
    # Host->device dtype for the streamed point upload in the test drivers
    # (points dominate h2d bytes at 16 KB/frustum in f32; relay-attached
    # setups are upload-bound, BENCH_NOTES "Driver e2e"). float16 halves the
    # bytes; decode back to the compute dtype on device. Worst-case
    # quantization is ~3 cm at z=64 m (KITTI) — AP-neutral on the 50-epoch
    # synthetic protocol (BENCH_NOTES "float16 point upload").
    C.TPU.INFER_POINTS_DTYPE = "float16"
    C.TPU.INFER_GROUP = 8  # batches per inference dispatch (engine/test.py)
    C.TPU.INFER_INFLIGHT = 2  # queued device dispatches before host fetch
    C.TPU.DONATE = True  # donate train-state buffers to the jitted step
    # Monitoring-metric cadence in the train loop: the reference computes the
    # rotated-IoU metric every step on the CPU (`models/det_base.py:495`);
    # the rebuild samples it every N steps (metric-free step otherwise).
    # -1 = every `disp` steps (default), 1 = reference every-step parity.
    C.TPU.METRIC_INTERVAL = -1
    # Analytic BN batch statistics in the PointNet MLPs (train only): stats
    # come from the layer-input second moment on the MXU instead of a
    # reduction over the (B, M, K, C) pre-activation. Same math as flax BN
    # (mean2 - mean^2), different summation order. Off by default.
    # Ghost-BN group size for train-mode batch statistics (0 = global-batch
    # sync-BN). group = per-GPU batch (e.g. 32) reproduces the reference's
    # multi-GPU DataParallel BN, where each replica normalizes over its own
    # sub-batch (train_net_det.py:308-309) — the semantics behind every
    # reference multi-GPU run; the reference never normalizes over more
    # than its per-GPU batch regardless of the global batch size. NOTE:
    # measured on the 50-epoch protocol, ghost-32 does NOT rescue the bf16
    # batch-128 recipe (74.7 AP — worse than sync-BN's 89.25; BENCH_NOTES
    # "Ghost-BN at scaled batch"); the knob is a semantics mechanism, not a
    # supported recipe ingredient.
    C.TPU.BN_GROUP_SIZE = 0
    # Precision schedule: run the FINAL N epochs of training with float32
    # compute regardless of COMPUTE_DTYPE (0 = off). Params/BN/optimizer
    # state are dtype-independent, so the switch is just a second jitted
    # step graph from the same TrainState; the LR schedule rides
    # state.step and is continuous across it. Two semantics to note: the
    # fine-tune epochs run FULLY float32 (TRUNK_DTYPE is intentionally not
    # applied to them), and N counts back from TRAIN.MAX_EPOCH — so the
    # supported "f16 for the first 10 epochs" recipe (N=40) assumes the
    # 50-epoch protocol schedule and shifts meaning if MAX_EPOCH differs.
    # Measured (BENCH_NOTES "float16 compute"): half-precision AP cost is
    # per-epoch and only recoverable by f32 epochs BEFORE the optimum forms
    # — the supported schedule is float16 + F32_FINETUNE_EPOCHS=40 at
    # batch 128/lr 4e-3 (f16 epochs 0-9 only), protocol AP
    # 90.15/90.31/90.31 (in band), amortized 2,178 f/s/chip = 10.2x; an
    # f32 tail AFTER the decay (N=10) recovers nothing.
    C.TPU.F32_FINETUNE_EPOCHS = 0
    # NOTE: FAST_BN / FAST_BN_FIRST compute *analytic sync-BN* statistics,
    # so they are intentionally inert while BN_GROUP_SIZE > 0 selects
    # ghost (per-group) statistics — DenseBNReLU routes to the GhostBN
    # path and the fast-stat option is dropped (models/net.py).
    C.TPU.FAST_BN = False
    # Analytic BN statistics on each scale's FIRST MLP layer only: the
    # (Cin, Cin) input moment is 3x3 there (grouped xyz), so the stat math
    # and its gradient are ~free while the skipped pre-activation reduction
    # + residual save cover the widest per-layer tensor of each scale.
    # Subsumed by FAST_BN when that is on; inert under ghost-BN (above).
    # Off by default.
    C.TPU.FAST_BN_FIRST = False
    # Rematerialize the per-scale PointNet MLP stacks in the backward pass
    # (jax.checkpoint): the train step's HBM floor is saving/reloading the
    # (B, M, K, C) activations; recomputing them from the 3-channel grouped
    # input trades cheap matmul FLOPs for that traffic. Gradients identical.
    C.TPU.REMAT_POINTNET = False
    return C


# The global config. Scripts merge yaml/CLI overrides into this then freeze it.
cfg = _build_default_cfg()


def get_default_cfg() -> AttrDict:
    """A fresh, mutable copy of the default config tree."""
    return _build_default_cfg()


def reset_cfg() -> AttrDict:
    """Reset the global ``cfg`` in place to defaults (mutable again).

    The engine CLIs merge into and then freeze the module-global ``cfg``;
    tools that chain several CLIs in one process (e.g. train then test)
    call this between stages.
    """
    cfg.immutable(False)
    fresh = _build_default_cfg()
    cfg.clear()
    for k, v in fresh.items():
        cfg[k] = v
    return cfg


def assert_and_infer_cfg(config: AttrDict | None = None, make_immutable: bool = True) -> AttrDict:
    """Finalize a config: resolve FILE aliases, sanity-check, then freeze."""
    c = cfg if config is None else config
    c.MODEL.FILE = MODEL_FILE_ALIASES.get(c.MODEL.FILE, c.MODEL.FILE)
    c.DATA.FILE = DATA_FILE_ALIASES.get(c.DATA.FILE, c.DATA.FILE)
    assert c.TEST.METHOD in ("nms", "top"), c.TEST.METHOD
    assert c.TRAIN.OPTIMIZER in ("adam", "sgd"), c.TRAIN.OPTIMIZER
    assert len(c.DATA.STRIDE) == len(c.DATA.HEIGHT_HALF)
    if make_immutable:
        c.immutable(True)
    return c


def merge_cfg_from_file(cfg_filename: str, config: AttrDict | None = None) -> None:
    """Merge a yaml config file into the (global) config."""
    with open(cfg_filename, "r") as f:
        yaml_cfg = AttrDict(_to_attrdict(yaml.safe_load(f)))
    _merge_a_into_b(yaml_cfg, cfg if config is None else config)


def merge_cfg_from_cfg(cfg_other: AttrDict, config: AttrDict | None = None) -> None:
    _merge_a_into_b(cfg_other, cfg if config is None else config)


def merge_cfg_from_list(cfg_list, config: AttrDict | None = None) -> None:
    """Merge ``[KEY, VALUE, KEY, VALUE, ...]`` CLI overrides (dotted keys)."""
    target = cfg if config is None else config
    assert len(cfg_list) % 2 == 0, "override list must be KEY VALUE pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = target
        for subkey in key_list[:-1]:
            assert subkey in d, f"Non-existent key: {full_key}"
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f"Non-existent key: {full_key}"
        value = _decode_cfg_value(v)
        value = _check_and_coerce_cfg_value_type(value, d[subkey], subkey, full_key)
        d[subkey] = value


def _to_attrdict(obj):
    if isinstance(obj, dict):
        return AttrDict({k: _to_attrdict(v) for k, v in obj.items()})
    return obj


def _merge_a_into_b(a: AttrDict, b: AttrDict, stack=None) -> None:
    assert isinstance(a, AttrDict) and isinstance(b, AttrDict)
    for k, v_ in a.items():
        full_key = ".".join(stack) + "." + k if stack is not None else k
        assert k in b, f"Non-existent config key: {full_key}"
        v = copy.deepcopy(v_)
        v = _decode_cfg_value(v)
        v = _check_and_coerce_cfg_value_type(v, b[k], k, full_key)
        if isinstance(v, AttrDict):
            _merge_a_into_b(v, b[k], (stack + [k]) if stack else [k])
        else:
            b[k] = v


def _decode_cfg_value(v):
    """Decode raw yaml/CLI values: parse strings as python literals if possible."""
    if isinstance(v, dict) and not isinstance(v, AttrDict):
        return AttrDict(_to_attrdict(v))
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _check_and_coerce_cfg_value_type(value, value_b, key, full_key):
    """Coerce ``value`` to the type of the default ``value_b`` where sensible."""
    type_b = type(value_b)
    type_a = type(value)
    if type_a is type_b or value_b is None:
        return value
    # numeric promotions
    if isinstance(value_b, float) and isinstance(value, int):
        return float(value)
    if isinstance(value_b, int) and isinstance(value, float) and value == int(value):
        return int(value)
    # container conversions
    if isinstance(value_b, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(value_b, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(value_b, np.ndarray):
        return np.array(value, dtype=value_b.dtype)
    if isinstance(value_b, str):
        return str(value)
    if isinstance(value_b, AttrDict) and isinstance(value, dict):
        return AttrDict(_to_attrdict(value))
    raise ValueError(
        f"Type mismatch ({type_b} vs {type_a}) for config key: {full_key}"
    )
