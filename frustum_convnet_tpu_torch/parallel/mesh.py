"""Data parallelism over processes: the port's ``parallel/mesh.py``.

Counterpart of ``frustum_convnet_tpu/parallel/mesh.py``. JAX runs one
process over many devices: the batch is sharded over a ``Mesh(('data',))``
and XLA inserts the collectives from the sharding annotations. The torch
idiom is one process per device, and here the collectives are explicit:

* each rank holds the whole model and uploads its own shard of the global
  batch; the loader cuts it (``BatchLoader(process_index=rank,
  process_count=world)``), which is what ``shard_batch`` and
  ``shard_full_batch`` do in JAX;
* every BatchNorm statistic, loss normaliser and metric that JAX reduces
  over the global batch is a sum over the ranks here (:func:`global_sum`,
  which carries a gradient); each rank's loss is its share of the global
  loss;
* after the backward the gradients are summed over the ranks
  (:func:`all_reduce_grads`, the JAX ``psum``). The sums come out bitwise
  equal on every rank, so Adam keeps the parameters bitwise equal;
* serving shards the dataset by whole batches (``BatchLoader(batch_shard=
  (rank, world))``) and merges the detection dicts once at the end
  (:func:`allgather_detections`).

Launching N ranks, one per card, each with ``--device cuda``:
``FRUSTUM_COORDINATOR=host:port FRUSTUM_NUM_PROCESSES=N
FRUSTUM_PROCESS_ID=r python -m frustum_convnet_tpu_torch.engine.train ...``
on each rank, or any launcher that sets ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK`` and ``WORLD_SIZE`` together with ``FRUSTUM_DIST=auto``. Rank r runs
on ``cuda:(r % device_count)``; the group's backend is NCCL on CUDA and
gloo on the CPU. Files are written by rank 0 only (:func:`is_chief`).
"""

from __future__ import annotations

import contextlib
import os
import socket
from typing import Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

_object_group = None  # gloo group for Python objects under an NCCL default group


def initialized() -> bool:
    """True when a process group is up."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def backend() -> Optional[str]:
    """The process group's backend ("nccl" or "gloo"), None without one."""
    return dist.get_backend() if initialized() else None


def is_chief() -> bool:
    """True on the rank that owns filesystem writes (checkpoints, result
    files, logs and scalars): every rank computes, rank 0 records."""
    return process_index() == 0


def init_args(env: Mapping[str, str], device_type: str,
              backend: Optional[str] = None) -> Optional[dict]:
    """The ``init_process_group`` arguments that ``env`` asks for, or None:

    * ``FRUSTUM_COORDINATOR=host:port``, ``FRUSTUM_NUM_PROCESSES`` and
      ``FRUSTUM_PROCESS_ID``: ``tcp://host:port`` with that world size and
      rank (the explicit ``jax.distributed.initialize``);
    * ``FRUSTUM_DIST=auto``: ``env://``, the launcher's ``MASTER_ADDR``,
      ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (the argless one).

    The backend is ``backend``, else NCCL for a CUDA device and gloo for
    the CPU."""
    coord = env.get("FRUSTUM_COORDINATOR")
    auto = env.get("FRUSTUM_DIST", "").lower() == "auto"
    if not coord and not auto:
        return None
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if coord:
        return {"backend": backend, "init_method": f"tcp://{coord}",
                "world_size": int(env["FRUSTUM_NUM_PROCESSES"]),
                "rank": int(env["FRUSTUM_PROCESS_ID"])}
    return {"backend": backend, "init_method": "env://"}


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda`` without an index becomes
    ``cuda:(rank % device_count)`` under a process group; anything else
    stays as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and initialized():
        return torch.device("cuda", process_index() % torch.cuda.device_count())
    return dev


def shared_devices(placements: Sequence[tuple]) -> dict:
    """{(host, cuda index): [ranks]} for every device that more than one
    rank of ``placements`` (one (host, index) a rank, in rank order) holds."""
    ranks: dict = {}
    for rank, where in enumerate(placements):
        ranks.setdefault(tuple(where), []).append(rank)
    return {where: rs for where, rs in ranks.items() if len(rs) > 1}


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group that the environment asks for (:func:`init_args`);
    a no-op that returns False when it asks for none. Returns True when a
    group is (already) up. Call it before anything touches the device.

    ``backend`` overrides the device's: NCCL refuses two ranks on one card,
    so a caller that puts several ranks on one card passes ``"gloo"`` (gloo
    all-reduces CUDA tensors too). Under NCCL the ranks compare their
    devices first, and a card held by two ranks raises on every rank
    instead of hanging in the first collective."""
    if initialized():
        return True
    dev = torch.device(device)
    args = init_args(os.environ, dev.type, backend)
    if args is None:
        return False
    dist.init_process_group(**args)
    dev = rank_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.get_backend() == "nccl" and process_count() > 1:
        placements = [None] * process_count()
        dist.all_gather_object(placements, (socket.gethostname(), dev.index),
                               group=_objects())
        shared = shared_devices(placements)
        if shared:
            shutdown()
            raise RuntimeError(
                "NCCL cannot run two ranks on one device: "
                + "; ".join(f"ranks {rs} on {host} cuda:{i}"
                            for (host, i), rs in shared.items())
                + ". Run one rank a card, or pass backend='gloo'.")
    return True


@contextlib.contextmanager
def distributed(device="cuda", backend: Optional[str] = None):
    """A driver's run inside the process group the environment asks for:
    joins it (:func:`maybe_initialize_distributed`) unless one is up,
    yields this rank's device (:func:`rank_device`), and leaves the group
    afterwards if it joined it here."""
    owned = not initialized() and maybe_initialize_distributed(device, backend)
    try:
        yield rank_device(device)
    finally:
        if owned:
            shutdown()


def shutdown() -> None:
    """Leave the process group (and the gloo group for objects)."""
    global _object_group
    if _object_group is not None:
        dist.destroy_process_group(_object_group)
        _object_group = None
    if initialized():
        dist.destroy_process_group()


def _objects():
    """The group that gathers Python objects: the default group under gloo,
    else a gloo group built once (all ranks reach it together)."""
    global _object_group
    if dist.get_backend() == "gloo":
        return None
    if _object_group is None:
        _object_group = dist.new_group(backend="gloo")
    return _object_group


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",)) -> int:
    """Check ``TPU.MESH_SHAPE`` / ``TPU.MESH_AXES`` against the process
    group and return the data-parallel width (the world size).

    JAX builds a device mesh of this shape inside one process; the port
    runs one process per device, so the only mesh is the data axis over
    all ranks: ``[-1]`` or ``[world]`` on ``("data",)``. Anything else
    (another axis, a second dimension, a width other than the world size)
    raises."""
    world = process_count()
    shape, axes = [int(d) for d in mesh_shape], [str(a) for a in axis_names]
    if axes != ["data"] or len(shape) != 1 or shape[0] not in (-1, world):
        raise ValueError(
            f"TPU.MESH_SHAPE {shape} with TPU.MESH_AXES {axes}: the port runs "
            f"one data-parallel axis over its {world} rank(s), one a device; "
            f"use TPU.MESH_SHAPE [-1] or [{world}] with TPU.MESH_AXES ['data']")
    return world


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place and return it; counts its calls in
    ``all_reduce.calls``."""
    dist.all_reduce(t)
    all_reduce.calls += 1
    return t


all_reduce.calls = 0  # collectives since the last reset


class _GlobalSum(torch.autograd.Function):
    """y = sum of x over the ranks, the same on every rank. Each rank's loss
    is its share of the global loss L = sum_r L_r, so dL/dx on rank k is
    the sum over the ranks of dL_r/dy: the backward all-reduces too."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format))


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, carrying a gradient; ``t`` itself
    when no group is up."""
    return _GlobalSum.apply(t) if initialized() else t


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum every parameter's ``.grad`` over the ranks in place, one flat
    buffer a dtype (the JAX ``psum`` of the gradients; a sum, not a mean,
    since each rank's loss is already its share). A no-op with no group."""
    if not initialized():
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def allgather_detections(det_results: dict) -> dict:
    """Merge the ranks' detection dicts ({frame id: {class: [rows]}}); every
    rank gets all of them, rank 0's rows first (``mesh.py:151-158`` of the
    JAX package). The identity at world size 1."""
    if process_count() == 1:
        return det_results
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, det_results, group=_objects())
    merged: dict = {}
    for d in gathered:
        for idx, per_class in d.items():
            for cls, rows in per_class.items():
                merged.setdefault(idx, {}).setdefault(cls, []).extend(rows)
    return merged
