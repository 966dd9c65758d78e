"""Inference/eval driver CLI of the port, on one device or one rank a device:
``python -m frustum_convnet_tpu_torch.engine.test --cfg <yaml> [--device cuda] [KEY VAL]...``

Counterpart of ``frustum_convnet_tpu/engine/test.py``: batched no-grad
inference over the (val|test) provider, per-frustum foreground selection
(``TEST.METHOD``: 'nms' keeps every section scored foreground with an argmax
fallback, 'top' keeps the single best section), decode back to KITTI boxes,
score = section cls prob + 2D detector prob, 3D rotated NMS at
``TEST.THRESH`` in the KITTI writer, and AP from the KITTI evaluator.

The streaming design is the JAX driver's: G batches flattened into one
forward, the section ladders rebuilt on the device from 6 floats per frustum,
the point stream uploaded as float16 and decoded to float32 on the device,
and only the compacted foreground sections brought back, all of them. The
model computes in ``TPU.INFER_DTYPE`` (its trunk and heads in
``TPU.TRUNK_DTYPE``) after the float32 grouping; decode and the host
postprocess take its heads' outputs, which are at least float32. The
numpy post-processing (box decode, packing for the writer) is carried over
from the JAX driver, whose module imports jax at the top. The SUN-RGBD
driver (``engine/test_sunrgbd.py``) makes the same serving call
(``serve_dataset``) with its own selection rule and postprocess.

Several cards serve as N processes, one a card, each with ``--device cuda``
and the environment of ``parallel.mesh`` (``FRUSTUM_COORDINATOR=host:port``,
``FRUSTUM_NUM_PROCESSES=N``, ``FRUSTUM_PROCESS_ID=r``). Serving is
embarrassingly parallel: rank r streams whole batches r, r + N, ...
(``BatchLoader(batch_shard=(r, N))``, whose item draws match a single
process's) through its own grouped forward, and one all-gather merges the
detection dicts at the end (``mesh.allgather_detections``). Rank 0 alone
makes the result directory, writes the files and the log and runs AP; the
other ranks return the merged detections. This per-rank batch sharding
also stands in for the JAX driver's sharding of one group over the devices
of a single process.
"""

from __future__ import annotations

import argparse
import os
import time
from collections import deque

import numpy as np
import torch

from frustum_convnet_tpu_torch import configs
from frustum_convnet_tpu_torch.data.provider import from_prediction_to_label_format_batch
from frustum_convnet_tpu_torch.data.registry import get_provider_class
from frustum_convnet_tpu_torch.engine import checkpoints as ckpt
from frustum_convnet_tpu_torch.engine.loader import BatchLoader
from frustum_convnet_tpu_torch.evaluation.kitti_writer import write_detection_results
from frustum_convnet_tpu_torch.models.det import decode_outputs
from frustum_convnet_tpu_torch.models.net import FrustumConvNet
from frustum_convnet_tpu_torch.ops.select_cuda import group_depth_point_multi_cuda
from frustum_convnet_tpu_torch.parallel import mesh
from frustum_convnet_tpu_torch.utils.logger import get_logger
from frustum_convnet_tpu_torch.utils.trace import span, spanned

INIT_SEED = 3  # the JAX driver's init seed for an evaluation without weights


def strict_fp32() -> None:
    """Full float32 matmuls and convolutions on the card. cuDNN convolutions
    default to TF32 (about three decimal digits), which would put the trunk
    far outside the port's float32 agreement with the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def upload_tensor(t: torch.Tensor, device: torch.device, dtype=None) -> torch.Tensor:
    """Host tensor ``t`` on ``device``, cast to ``dtype`` on the host. To a
    card it is staged in page-locked memory and copied without waiting: the
    copy is queued behind the work already on the stream and the host goes
    on (the host allocator reuses the staging block only after the copy)."""
    if device.type != "cuda":
        return (t if dtype is None else t.to(dtype)).to(device)
    staged = torch.empty(t.shape, dtype=dtype or t.dtype, pin_memory=True).copy_(t)
    return staged.to(device, non_blocking=True)


def rebuild_ladders(ref_dir, ref_off, z_grids):
    """Section ladders (B, M_i, 3) from the affine basis ``ref(z) = z * dir
    + off`` (``FrustumProvider.ref_basis``, (B, 3) each) and the static
    per-scale depth grids (M_i,). Multiply, then add, in two roundings: the
    JAX driver's order, so the ladders and the hard depth windows on them
    agree bit for bit."""
    return tuple(ref_off[:, None, :] + ref_dir[:, None, :] * z[None, :, None]
                 for z in z_grids)


def kitti_rule(out: dict, top: bool) -> tuple:
    """KITTI's selection on the decoded outputs, the JAX driver's: the
    foreground mask p1 > p0 (None under 'top') and the packed value, p1."""
    probs = out["cls_probs"]  # (R, L, 2)
    return None if top else probs[:, :, 1] > probs[:, :, 0], probs[:, :, 1]


def build_infer_group_fn(model, spec, method: str, z_grids=None, rule=kitti_rule):
    """G stacked batches -> one flattened (G*B) forward, with the selection
    on the device.

    Returns, per frustum, only the selected sections packed as (G, B, S, 8) =
    [cx, cy, cz, heading, l, w, h, value] plus their count (G, B).
    ``rule(out, top)`` is the family's selection on the decoded outputs: the
    foreground mask (None under 'top') and the packed value. 'nms' keeps
    every foreground section in section order (the argmax where a frustum
    has none), S = L, so none is left out; 'top' keeps the argmax, S = 1.
    The refs argument is the ladders, (G, B, M_i, 3) each, or the affine
    basis (ref_dir, ref_off), (G, B, 3) each, whose ladders are rebuilt on
    the device as ``off + dir * z`` over ``z_grids``.
    """
    sel_top = method != "nms"
    device = next(model.parameters()).device
    z_consts = (None if z_grids is None else
                [upload_tensor(torch.from_numpy(np.asarray(z, np.float32)), device)
                 for z in z_grids])

    @torch.inference_mode()
    def infer_group(pts_g, one_hot_g, refs_g):
        g, b = pts_g.shape[:2]

        def flat(x):
            return x.reshape((g * b,) + tuple(x.shape[2:]))

        refs = tuple(flat(r) for r in refs_g)
        if refs[0].dim() == 2:  # the basis
            refs = rebuild_ladders(*refs, z_consts)
        # pts may arrive in the reduced upload dtype: kernel 1 takes float32
        cls_logits, reg = model(flat(pts_g).float(), flat(one_hot_g), list(refs))
        out = decode_outputs(spec, cls_logits, reg, refs[1])
        fg, value = rule(out, sel_top)
        sel, cnt = compact_sections(out["cls_probs"][:, :, 1], fg)
        packed = take_sections(sel, out["centers"], out["headings"], out["sizes"],
                               value)  # (G*B, S, 8)
        return packed.reshape(g, b, *packed.shape[1:]), cnt.reshape(g, b)

    return infer_group


def compact_sections(fg_prob: torch.Tensor, fg) -> tuple:
    """On the device, the selected sections of each frustum (R, L): with
    ``fg`` None the argmax of ``fg_prob`` (S = 1), else the sections of
    ``fg`` (the argmax where a frustum has none) in section order (S = L).
    Returns (sel (R, S) long, cnt (R,) int32); the slots past a frustum's
    count hold section 0."""
    rows, length = fg_prob.shape
    top = torch.argmax(fg_prob, dim=1)  # (R,)
    if fg is None:
        return top[:, None], torch.ones(rows, dtype=torch.int32, device=fg_prob.device)
    none = ~fg.any(dim=1)
    ar = torch.arange(length, dtype=torch.int32, device=fg_prob.device)
    fg = fg | (none[:, None] & (ar[None, :] == top[:, None]))
    key = torch.where(fg, ar, ar + length)
    neg, _ = torch.topk(-key, length, dim=1, largest=True, sorted=True)
    sel_all = torch.clamp(-neg, max=length - 1)  # the fg sections first
    cnt = fg.sum(dim=1).to(torch.int32)
    sel = torch.where(ar[None, :] < cnt[:, None], sel_all, torch.zeros_like(sel_all))
    return sel.long(), cnt


def take_sections(sel: torch.Tensor, centers, headings, sizes, value) -> torch.Tensor:
    """(R, S, 8) = [cx, cy, cz, heading, l, w, h, value] of sections ``sel``
    (R, S) from (R, L, 3), (R, L), (R, L, 3) and (R, L)."""

    def take(x):
        if x.dim() == 3:
            return torch.gather(x, 1, sel[..., None].expand(-1, -1, x.shape[2]))
        return torch.gather(x, 1, sel)

    return torch.cat([take(centers), take(headings)[..., None], take(sizes),
                      take(value)[..., None]], dim=-1)


def queue_fetch(out_dev: tuple, device) -> tuple:
    """(host outputs, the event after their copy or None, the device
    outputs, kept until that event). On a card the copy back to page-locked
    memory is queued behind the work already on the stream, then an event."""
    if device.type != "cuda":
        return out_dev, None, out_dev
    host = tuple(t.to("cpu", non_blocking=True) for t in out_dev)  # pinned
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done, out_dev


def stream_groups(batches, group: int, inflight: int, device, spans: dict, upload,
                  forward, postprocess, logger=None, num_groups: int = 0) -> dict:
    """The group pipeline of the serving call (``serve_dataset``) over its
    loader's ``batches``.

    ``group`` batches at a time, the final partial group padded by
    repeating its last batch: ``upload(batches, tail)`` stacks and uploads
    them (span ``serve.upload``; ``tail`` is True for the padded group) and
    returns the device inputs; ``forward(*inputs)`` queues the grouped
    forward and returns its device outputs, whose copy back is queued right
    behind it with an event (span ``serve.dispatch``). Once ``inflight``
    groups are queued the oldest is fetched: ``serve.fetch`` waits on its
    event alone, then ``postprocess(host, g, batch)`` takes each of its real
    batches (numpy outputs, the batch's index in the group; span
    ``serve.postprocess``).

    Returns {"frustums": real frustums streamed, "fetch_waited": groups
    whose outputs were not back yet when fetched (0 off a card)}."""
    pending: deque = deque()  # (queue_fetch of a group, its batches), oldest first
    acc: list = []
    n = gi = waited = 0
    t_start = time.time()

    def process(fetch, real) -> None:
        nonlocal waited
        host, done, _ = fetch
        with span("serve.fetch", spans):
            if done is not None:
                if not done.query():
                    waited += 1
                done.synchronize()  # this group's copy, not the groups after it
            outs = tuple(t.numpy() for t in host)
        for g, batch in enumerate(real):
            with span("serve.postprocess", spans):
                postprocess(outs, g, batch)

    def launch(real: list) -> None:
        nonlocal gi
        with span("serve.upload", spans):
            inputs = upload(real + [real[-1]] * (group - len(real)), len(real) < group)
        with span("serve.dispatch", spans):  # the copy back before the next upload
            fetch = queue_fetch(forward(*inputs), device)
        pending.append((fetch, real))
        while len(pending) >= max(inflight, 1):
            process(*pending.popleft())
        gi += 1
        if logger is not None and gi % 10 == 0:
            rate = n / (time.time() - t_start)
            logger.info(f"group {gi}/{num_groups}  {rate:.0f} frustums/s e2e")

    for batch in spanned(batches, "serve.loader_wait", spans):
        n += int(batch["_real"])
        acc.append(batch)
        if len(acc) == group:
            launch(acc)
            acc = []
    if acc:
        launch(acc)
    while pending:
        process(*pending.popleft())
    return {"frustums": n, "fetch_waited": waited}


def _accumulate_detections(centers, headings, sizes, fg_probs, det_b,
                           batch: dict, dataset, det_results: dict) -> int:
    """Decode gathered detections (D, ...) to KITTI boxes, drop degenerate
    sizes, score = fg prob + 2D detector prob, append to ``det_results``.
    Returns the number of detections kept."""
    idxs = batch["_indices"]
    rgb_probs = np.asarray(
        batch.get("rgb_prob", np.ones(len(idxs), np.float32))).reshape(-1)
    rot_angles = np.asarray(batch["rot_angle"]).reshape(-1)
    ref_centers = batch.get("ref_center")

    boxes = from_prediction_to_label_format_batch(
        centers, headings, sizes, rot_angles[det_b],
        None if ref_centers is None else np.asarray(ref_centers)[det_b],
    )  # (D, 7) = h w l tx ty tz ry
    scores = fg_probs + rgb_probs[det_b]

    ok = (boxes[:, 0] >= 0.01) & (boxes[:, 1] >= 0.01) & (boxes[:, 2] >= 0.01)
    det_b, boxes, scores = det_b[ok], boxes[ok], scores[ok]

    ids = dataset.data["id"]
    types = dataset.data["type"]
    box2ds = dataset.data["box2d"]
    for d in range(len(det_b)):
        gi = int(idxs[det_b[d]])
        b2 = box2ds[gi]
        h, w, l, tx, ty, tz, ry = boxes[d]
        det_results.setdefault(int(ids[gi]), {}).setdefault(types[gi], []).append(
            [b2[0], b2[1], b2[2], b2[3], tx, ty, tz, h, w, l, ry, float(scores[d])])
    return len(det_b)


def postprocess_packed(packed: np.ndarray, cnt: np.ndarray, batch: dict,
                       dataset, det_results: dict) -> int:
    """Detections of one packed batch: packed (B, S, 8), cnt (B,). Returns
    the number of detections kept."""
    real = int(batch["_real"])
    slot = np.arange(packed.shape[1])
    det_b, det_s = np.nonzero(slot[None, :] < cnt[:real, None])
    if det_b.size == 0:
        return 0
    rows = packed[det_b, det_s]  # (D, 8)
    return _accumulate_detections(rows[:, 0:3], rows[:, 3], rows[:, 4:7],
                                  rows[:, 7], det_b, batch, dataset, det_results)


def _postprocess_kitti(packed, cnt, batch: dict, dataset, det_results: dict,
                       counts: dict) -> None:
    """KITTI's batch postprocess in ``serve_dataset``: ``postprocess_packed``,
    its selected sections and kept detections added to ``counts``."""
    counts["sections"] += int(cnt[:int(batch["_real"])].sum())
    counts["detections"] += postprocess_packed(packed, cnt, batch, dataset, det_results)


def serve_dataset(model, spec, dataset, batch_size: int, method: str, logger, rule,
                  postprocess, counts: dict, num_workers: int, group: int, inflight: int,
                  points_dtype: torch.dtype) -> tuple:
    """The serving call of both drivers: stream ``dataset`` through
    ``model`` on its device and accumulate detections. A family gives its
    selection ``rule`` (``build_infer_group_fn``), its host
    ``postprocess(packed, cnt, batch, dataset, det_results, counts)`` of one
    batch and the ``counts`` that adds to.

    BatchLoader threads prepare batches ahead; G batches go to the device as
    one forward, the final partial group padded by repeating its last batch;
    the host post-processes a finished group a batch at a time while up to
    ``inflight`` groups are queued on the device (``stream_groups``). On a
    card nothing in the group loop waits for it but the fetch of the oldest
    group: the uploads are staged in page-locked memory and queued without
    waiting, the size table lives on the card, and right after a group's
    forward is queued its outputs' copy back is queued behind it and
    followed by an event, which the fetch waits on alone. From a dataset
    with ``ref_basis`` a group uploads the 6 floats of a frustum's ladder
    basis and its ladders are rebuilt on the device; the tail group uploads
    the provider's ladders, as the JAX driver's tail takes them.

    Under a process group of N > 1 ranks this rank streams its batch shard
    and the ranks' detections are merged at the end, so every rank returns
    them all; the stats are this rank's.

    Returns (det_results, {"frustums", "seconds", "frustums_per_s",
    **counts, "fetch_waited", "spans"}): ``frustums`` counts the real
    frustums streamed here, ``fetch_waited`` the groups whose outputs were
    not back yet when the host came to fetch them (the card set the pace;
    always 0 off a card), and ``spans`` the host time of the call's parts
    (``utils.trace``: {name: {"n": entries, "s": seconds}}): ``serve.call``
    the whole call, ``serve.start`` the set-up before the stream,
    ``serve.loader_wait`` each wait on the loader, ``serve.upload`` a
    group's stack, cast and copies to the device, ``serve.dispatch`` the
    launch of its forward and of its outputs' copy back, ``serve.fetch`` the
    host waiting for that copy and ``serve.postprocess`` a batch's host
    postprocess.
    """
    spans: dict = {}
    with span("serve.call", spans):
        with span("serve.start", spans):
            strict_fp32()
            model.eval()
            device = next(model.parameters()).device
            group = max(int(group), 1)
            z_grids = dataset.ref_depths() if hasattr(dataset, "ref_basis") else None
            infer_group = build_infer_group_fn(model, spec, method, z_grids, rule)
            pc, pi = mesh.process_count(), mesh.process_index()
            loader = BatchLoader(dataset, batch_size, spec.num_scales, shuffle=False,
                                 drop_last=False, pad_last=True, seed=0,
                                 num_workers=num_workers,
                                 batch_shard=(pi, pc) if pc > 1 else None)
        num_groups = (len(range(pi, len(loader), pc)) + group - 1) // group
        det_results: dict = {}

        def upload(arrays, dtype=None):
            x = np.ascontiguousarray(np.stack(arrays))
            return upload_tensor(torch.from_numpy(x), device, dtype)

        def upload_group(batches, tail: bool) -> tuple:
            pts_g = upload([b["point_cloud"] for b in batches], points_dtype)
            oh_g = upload([b["one_hot"] for b in batches])
            if z_grids is None or tail:
                refs_g = tuple(upload([b["refs"][i] for b in batches])
                               for i in range(spec.num_scales))
            else:  # ladders rebuilt on the device from 6 floats a frustum
                refs_g = (upload([b["ref_dir"] for b in batches]),
                          upload([b["ref_off"] for b in batches]))
            return pts_g, oh_g, refs_g

        def postprocess_group(host, g, batch) -> None:
            packed_g, cnt_g = host
            postprocess(packed_g[g], cnt_g[g], batch, dataset, det_results, counts)

        t_start = time.time()
        launches = group_depth_point_multi_cuda.launches
        streamed = stream_groups(loader.epoch(0), group, inflight, device, spans,
                                 upload_group, infer_group, postprocess_group,
                                 logger=logger, num_groups=num_groups)
        n = streamed["frustums"]
        elapsed = time.time() - t_start
        where = f" on rank {pi} of {pc}" if pc > 1 else ""
        logger.info(f"streamed {n} frustums{where} in {elapsed:.2f}s = "
                    f"{n / elapsed:.0f} frustums/s end-to-end ("
                    + ", ".join(f"{v} {k}" for k, v in counts.items()) + ")")
        logger.info(f"{group_depth_point_multi_cuda.launches - launches} grouping kernel "
                    f"launches in serving")
        stats = {"frustums": n, "seconds": elapsed, "frustums_per_s": n / elapsed,
                 **counts, "fetch_waited": streamed["fetch_waited"]}
        if pc > 1:  # one collective merges the ranks' detection dicts
            det_results = mesh.allgather_detections(det_results)
    stats["spans"] = spans
    return det_results, stats


def run_test(model, spec, dataset, batch_size: int, method: str, logger,
             num_workers: int = 4, group: int = 8, inflight: int = 2,
             points_dtype: torch.dtype = torch.float16):
    """Stream the KITTI ``dataset`` through ``model`` on its device in
    groups of ``group`` batches (``serve_dataset``); accumulate detections.

    Returns (det_results, stats): the KITTI writer's detection dict and
    {"frustums", "seconds", "frustums_per_s", "sections", "detections",
    "overflow_reruns", "fetch_waited", "spans"} as ``serve_dataset`` counts them:
    ``sections`` the selected foreground sections (argmax fallbacks
    included), ``detections`` those left after degenerate boxes are dropped
    and ``overflow_reruns`` 0, since every foreground section comes back.
    """
    return serve_dataset(model, spec, dataset, batch_size, method, logger, kitti_rule,
                         _postprocess_kitti,
                         {"sections": 0, "detections": 0, "overflow_reruns": 0},
                         num_workers, group, inflight, points_dtype)


def load_state_for_test(model, cfg_, logger) -> None:
    """Load ``cfg_.TEST.WEIGHTS`` (a reference-layout ``.pth``) into ``model``,
    or keep its initialization when unset."""
    weights = cfg_.TEST.WEIGHTS
    if weights:
        ckpt.load_checkpoint(weights, model)
        logger.info(f"loaded weights {weights}")
    else:
        logger.warning("TEST.WEIGHTS not set — evaluating random init")


def make_dataset(cfg):
    """The config's test split (``TEST.DATASET``) through its registered
    provider, as the driver streams it."""
    provider_cls = get_provider_class(cfg)
    return provider_cls(cfg, cfg.TEST.DATASET, one_hot=True,
                        from_rgb_detection=cfg.FROM_RGB_DET,
                        overwritten_data_path=cfg.OVER_WRITE_TEST_FILE)


def package_test_results(result_dir: str) -> str:
    """Zip ``result_dir``'s contents into a sibling ``results.zip`` for
    KITTI test-server submission; archive paths are relative to
    ``result_dir`` (``data/xxxxxx.txt``)."""
    import zipfile

    zip_path = os.path.join(os.path.dirname(os.path.abspath(result_dir)),
                            "results.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(result_dir):
            for name in sorted(files):
                full = os.path.join(root, name)
                zf.write(full, os.path.relpath(full, result_dir))
    return zip_path


def main(argv=None):
    """Run the driver; returns {"ap": AP results or None, "stats": run_test's
    stats, "result_dir": the written ``data`` directory (None off rank 0),
    "det_results": the detections of every rank}."""
    parser = argparse.ArgumentParser(description="Test FrustumConvNet (PyTorch)")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--gt_dir", default="data/kitti/training/label_2")
    parser.add_argument("--idx_path", default="",
                        help="split id file for empty-result fill")
    parser.add_argument("--no_eval", action="store_true")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = configs.get_default_cfg()
    configs.merge_cfg_from_file(args.cfg_file, cfg)
    if args.opts:
        configs.merge_cfg_from_list(args.opts, cfg)
    configs.assert_and_infer_cfg(cfg)
    dtype = configs.get_compute_dtype(cfg, train=False)
    trunk_dtype = configs.get_trunk_dtype(cfg)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device is visible")
    # the process group before anything touches the device (env-gated)
    with mesh.distributed(device) as device:
        return _serve(cfg, args, device, dtype, trunk_dtype)


def _serve(cfg, args, device, dtype, trunk_dtype) -> dict:
    mesh.make_mesh(cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES)
    chief = mesh.is_chief()
    result_dir = os.path.join(cfg.OUTPUT_DIR, cfg.SAVE_SUB_DIR, "result")
    if chief:  # files belong to rank 0; the other ranks log to the console
        os.makedirs(result_dir, exist_ok=True)
    logger = get_logger(os.path.join(result_dir, "test.log") if chief else None)

    spec = configs.get_model_spec(cfg)
    model = FrustumConvNet(spec, dtype=dtype, trunk_dtype=trunk_dtype)
    model.reset_parameters(torch.Generator().manual_seed(INIT_SEED))
    model.to(device).eval()
    dataset = make_dataset(cfg)
    logger.info(f"test frustums: {len(dataset)} on {device}")

    # the empty-file fill is part of the devkit protocol (a frame without a
    # result file drops out of AP): the split file is found next to
    # DATA_ROOT or passed with --idx_path, and is required for evaluation;
    # checked before the inference pass
    idx_path = args.idx_path
    if not idx_path:
        split = cfg.TEST.DATASET.replace("_rgb_detection", "")
        for cand in (os.path.join(cfg.DATA.DATA_ROOT, "image_sets",
                                  f"{split}.txt"),
                     os.path.join(cfg.DATA.DATA_ROOT, "..", "image_sets",
                                  f"{split}.txt")):
            if os.path.exists(cand):
                idx_path = cand
                logger.info(f"using split ids from {cand} for empty-file fill")
                break
    split_ids = []
    if idx_path and os.path.exists(idx_path):
        with open(idx_path) as f:
            split_ids = [int(line.strip()) for line in f if line.strip()]
    elif "test" not in cfg.TEST.DATASET and not args.no_eval:
        raise FileNotFoundError(
            "no split id file found for the empty-result fill — pass "
            "--idx_path <image_sets/{split}.txt>; evaluating without it "
            "excludes zero-detection frames from AP")

    load_state_for_test(model, cfg, logger)
    det_results, stats = run_test(
        model, spec, dataset, cfg.TEST.BATCH_SIZE, cfg.TEST.METHOD, logger,
        group=cfg.TPU.INFER_GROUP, inflight=cfg.TPU.INFER_INFLIGHT,
        points_dtype=configs.get_points_upload_dtype(cfg))
    if not chief:  # run_test merged every rank's detections; rank 0 writes
        return {"ap": None, "stats": stats, "result_dir": None,
                "det_results": det_results}
    nms_thresh = cfg.TEST.THRESH if cfg.TEST.METHOD == "nms" else None
    data_dir = write_detection_results(result_dir, det_results, split_ids,
                                       nms_threshold=nms_thresh)
    logger.info(f"results written to {data_dir}")

    results = None
    if "test" in cfg.TEST.DATASET:
        zip_path = package_test_results(result_dir)
        logger.info(f"results file saved in {result_dir}; packaged {zip_path}")
    elif not args.no_eval:
        from frustum_convnet_tpu_torch.evaluation import kitti_eval
        results = kitti_eval.evaluate(args.gt_dir, result_dir,
                                      classes=("car", "pedestrian", "cyclist")
                                      if not cfg.DATA.CAR_ONLY else ("car",))
        logger.info(f"AP results: {results}")
    return {"ap": results, "stats": stats, "result_dir": data_dir,
            "det_results": det_results}


if __name__ == "__main__":
    main()
