"""Host-side batch loader: shuffling, multi-host sharding, threaded prefetch.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=4,
pin_memory, drop_last)`` (reference `train/train_net_det.py:262-286`)
with a TPU-appropriate design:

* deterministic per-epoch shuffling from a seeded generator (seed 3 + epoch);
* every host reads only its ``jax.process_index()`` shard of each global
  batch (multi-host data parallelism needs no other change);
* background threads assemble the next batches while the device computes
  (the analogue of dataloader workers — numpy item prep releases the GIL
  enough for a few threads to scale, and avoids fork overhead); batch order
  is deterministic and independent of the worker count (per-batch seeded
  rng, round-robin queue consumption);
* static shapes: ``drop_last`` for training, ``pad_last`` for inference.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Iterator, Optional

import numpy as np

from frustum_convnet_tpu_torch.data.provider import collate_batch


class _WorkerError:
    """A worker's exception, carried across the queue with its traceback
    (a bare sentinel would swallow the root cause — painful at epoch 37 of
    a 50-epoch run)."""

    def __init__(self, exc: BaseException):
        self.exc = exc
        self.traceback = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__))


class BatchLoader:
    def __init__(self, dataset, batch_size: int, num_scales: int,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 3,
                 prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 pad_last: bool = False, num_workers: int = 1,
                 batch_shard: Optional[tuple] = None):
        self.dataset = dataset
        self.global_batch = batch_size
        if batch_size % process_count != 0:
            raise ValueError(
                f"batch size {batch_size} must be divisible by the process "
                f"count {process_count}: every host feeds an equal shard of "
                f"the global batch. Pick TRAIN/TEST.BATCH_SIZE as a multiple "
                f"of {process_count}.")
        self.local_batch = batch_size // process_count
        self.num_scales = num_scales
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        # pad_last: repeat the final item so every batch has the compiled
        # static shape; batches then carry '_indices' (dataset indices incl.
        # pads) and '_real' (valid count) for the consumer to trim
        self.pad_last = pad_last
        # num_workers > 1: round-robin batch assembly across threads (numpy
        # releases the GIL often enough for this to scale to a few threads);
        # batch order is preserved by consuming the per-worker queues in turn
        self.num_workers = max(1, num_workers)
        # batch_shard=(pi, pc): multi-host INFERENCE sharding — this host
        # assembles and yields only batches pi, pi+pc, ... in full (no
        # within-batch slicing; inference is embarrassingly parallel across
        # hosts, detections merge at the end). Item rng is keyed without the
        # process index so any host layout resamples identically to a
        # single-process run. Mutually exclusive with within-batch sharding.
        if batch_shard is not None and process_count != 1:
            raise ValueError("batch_shard and within-batch process sharding "
                             "are mutually exclusive")
        self.batch_shard = batch_shard

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.global_batch
        return (n + self.global_batch - 1) // self.global_batch

    def epoch(self, epoch: int) -> Iterator[dict]:
        """Yield collated numpy batches for one epoch (prefetched)."""
        order_rng = np.random.default_rng(self.seed + epoch)
        n = len(self.dataset)
        order = order_rng.permutation(n) if self.shuffle else np.arange(n)

        num_batches = len(self)
        nw = self.num_workers
        queues: list["queue.Queue[Optional[dict]]"] = [
            queue.Queue(maxsize=max(1, self.prefetch)) for _ in range(nw)
        ]

        def make_batch(b: int, item_rng) -> dict:
            sel = order[b * self.global_batch:(b + 1) * self.global_batch]
            if (not self.pad_last and not self.drop_last
                    and len(sel) < self.global_batch):
                # final short batch without padding: a per-host slice could
                # be empty or host-divergent, so EVERY host loads the full
                # global tail and evaluates it identically (unsharded) —
                # val metrics stay host-consistent and no item is dropped
                # (ref drop_last=False, `train_net_det.py:279-286`).
                # rng is keyed WITHOUT process_index: item resampling draws
                # must match across hosts for the metrics to agree.
                tail_rng = np.random.default_rng((self.seed, epoch, b))
                batch = collate_batch(
                    [self.dataset.__getitem__(int(i), tail_rng) for i in sel],
                    self.num_scales)
                batch["_global_tail"] = True
                return batch
            # this host's contiguous sub-shard of the global batch
            lo = self.process_index * self.local_batch
            sel = sel[lo:lo + self.local_batch]
            real = len(sel)
            if self.pad_last and real < self.local_batch:
                # a host whose sub-shard lies fully past the dataset tail
                # gets an all-pad batch (real == 0) built from item 0
                fill = sel[-1] if real else order[0]
                sel = np.concatenate(
                    [sel, np.full(self.local_batch - real, fill)])
            items = [self.dataset.__getitem__(int(i), item_rng) for i in sel]
            batch = collate_batch(items, self.num_scales)
            if self.pad_last:
                batch["_indices"] = np.asarray(sel)
                batch["_real"] = real
            return batch

        # this host's batch indices: all of them, or its batch_shard stride
        if self.batch_shard is not None:
            pi, pc = self.batch_shard
            my_batches = list(range(pi, num_batches, pc))
        else:
            my_batches = list(range(num_batches))

        def worker(w: int):
            # per-batch rng keyed by batch index keeps augmentation draws
            # independent of the worker count (and, under batch_shard, of
            # the host layout: the key matches a single-process run's)
            try:
                for b in my_batches[w::nw]:
                    key_pi = 0 if self.batch_shard else self.process_index
                    item_rng = np.random.default_rng(
                        (self.seed, epoch, key_pi, b))
                    queues[w].put(make_batch(b, item_rng))
            except BaseException as exc:  # propagate with full traceback
                queues[w].put(_WorkerError(exc))
            else:
                queues[w].put(None)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(nw)]
        for t in threads:
            t.start()
        # worker w produces my_batches[w::nw] in order, so consuming the
        # queues round-robin reconstructs this host's batch order exactly
        for i in range(len(my_batches)):
            batch = queues[i % nw].get()
            if isinstance(batch, _WorkerError):
                raise RuntimeError(
                    f"BatchLoader worker {i % nw} failed while assembling "
                    f"batch {my_batches[i]} of epoch {epoch}:\n"
                    f"{batch.traceback}"
                ) from batch.exc
            if batch is None:  # worker ended before finishing its share
                raise RuntimeError(
                    f"BatchLoader worker {i % nw} exited early (expected "
                    f"batch {my_batches[i]} of {num_batches})")
            yield batch
