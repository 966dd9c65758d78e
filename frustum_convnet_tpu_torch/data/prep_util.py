"""Shared helper for the prep CLIs' per-frame process-pool fan-out.

All three offline extraction CLIs (KITTI stage-1 / refine, SUN-RGBD) process
frames independently with a per-frame-seeded rng, so their outputs are
identical for any worker count; this is the single copy of the pool/merge
boilerplate they share.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence


def parallel_map_frames(work: Callable, idx_list: Sequence[int],
                        workers: int = 1, chunksize: int = 16) -> List:
    """``[work(i) for i in idx_list]``, optionally over a spawn-mode pool.

    spawn, not fork: the host process may have live JAX/XLA threads (fork
    would risk deadlock); ``work`` must be picklable (module-level function
    or functools.partial of one).
    """
    if workers > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(workers) as pool:
            return pool.map(work, idx_list, chunksize=chunksize)
    return [work(i) for i in idx_list]


def merge_frame_outputs(results: Sequence[Dict[str, list]],
                        fields: Sequence[str]) -> Dict[str, list]:
    """Concatenate per-frame {field: list} dicts in frame order."""
    out: Dict[str, list] = {k: [] for k in fields}
    for frame_out in results:
        for k in fields:
            out[k].extend(frame_out[k])
    return out
