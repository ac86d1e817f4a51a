"""Frame-axis-sharded unique-CC tracking with an associative cross-shard
merge — the parallel reformulation of the reference's strictly sequential
streaming tracker (reference: cc_stability_estimator.py:126-145; SURVEY.md
§5 long-context note).

Semantics are EXACTLY the sequential CCTracker's (bit-identical tracks):

  * per-frame CC extraction (the expensive part: labeling + mask slicing)
    is embarrassingly parallel — each shard extracts and locally tracks its
    contiguous frame range independently, optionally on worker processes;
  * ``merge_trackers(left, right)`` is an associative fold that replays the
    right shard's pre-extracted CC lists into the left tracker's state.
    Replay uses a fast path: while no *left-origin* active unique CC's bbox
    intersects the current frame's CCs and no decision has diverged, the
    right shard's local assignments are provably identical to sequential
    matching (all left-origin candidates sort before right-origin ones and
    none can pixel-match without a bbox hit), so they are adopted wholesale
    with renumbering. The moment a left-origin candidate interferes, the
    frame is re-matched by the exact sequential rule and compared; only a
    genuinely different decision switches the remainder of the shard to
    full re-matching.

The fast path makes interior shards of a lecture whose content retires
within ``max_gap`` adopt-only; a fully static board degrades gracefully to
re-matching (still skipping re-extraction, which dominates add_frame).
Shard-count invariance (1 == 2 == 4 == 8 shards, fold or tree reduction) is
asserted in tests/test_sharded_tracking.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.cc import CC, extract_ccs
from .cc_tracking import CCTracker


def track_shard(ccs_per_frame: Sequence[List[CC]], width: int, height: int,
                min_recall: float, min_precision: float,
                max_gap: int) -> CCTracker:
    """Sequentially track pre-extracted per-frame CC lists (one shard)."""
    tracker = CCTracker(width, height, min_recall, min_precision, max_gap)
    for ccs in ccs_per_frame:
        tracker.add_frame_ccs(ccs)
    return tracker


def slim_frame_masks(tracker: CCTracker) -> CCTracker:
    """Drop per-frame mask crops in place (and mark the tracker slim) —
    the full-lecture memory lever (see CCTracker.keep_frame_masks).
    First-seen masks in unique_ccs are untouched; stage-03 results are
    identical (tested)."""
    from dataclasses import replace

    tracker.cc_idx_per_frame = [
        [(uidx, cc if cc.img is None else replace(cc, img=None))
         for uidx, cc in frame]
        for frame in tracker.cc_idx_per_frame]
    tracker.keep_frame_masks = False
    return tracker


def merge_trackers(left: CCTracker, right: CCTracker) -> CCTracker:
    """Fold the ``right`` shard's tracked frames into ``left`` (mutates and
    returns ``left``). Associative; equals sequential tracking over the
    concatenated frame ranges."""
    assert (left.width, left.height) == (right.width, right.height)
    assert (left.min_recall, left.min_precision, left.max_gap) == \
        (right.min_recall, right.min_precision, right.max_gap)
    if not right.keep_frame_masks:
        raise ValueError(
            "merge_trackers: the right shard must retain per-frame masks "
            "(keep_frame_masks=True) — its frames are re-matched into the "
            "merged tracker. Only the accumulating LEFT side may run slim.")

    left_origin_end = len(left.unique_ccs)  # merged idx < this => left-origin
    mapping = {}  # right local uidx -> merged uidx
    diverged = False

    for frame in right.cc_idx_per_frame:
        ccs = [cc for _, cc in frame]

        if diverged:
            left.add_frame_ccs(ccs)
            continue

        if not _left_actives_interfere(left, ccs, left_origin_end):
            _adopt_frame(left, frame, mapping)
            continue

        # a left-origin active could match: re-run the exact sequential
        # rule for this frame, then check the local decisions still hold
        before = len(left.unique_ccs)
        left.add_frame_ccs(ccs)
        entries = left.cc_idx_per_frame[-1]
        for (merged_uidx, _), (local_uidx, _) in zip(entries, frame):
            expected = mapping.get(local_uidx)
            if expected is not None:
                if merged_uidx != expected:
                    diverged = True
                    break
            elif merged_uidx >= before:  # new unique both locally and merged
                mapping[local_uidx] = merged_uidx
            else:
                diverged = True
                break

    return left


def _left_actives_interfere(left: CCTracker, ccs: List[CC],
                            left_origin_end: int) -> bool:
    """True when any still-active left-origin unique CC's bbox intersects a
    current-frame CC bbox (i.e. sequential matching could differ from the
    right shard's local matching)."""
    if not ccs or not left._active:
        return False
    active = np.asarray(left._active)
    left_mask = active < left_origin_end
    if not left_mask.any():
        return False
    boxes = left._active_boxes[left_mask]  # (min_x, max_x, min_y, max_y)
    cur = np.array([[c.min_x, c.max_x, c.min_y, c.max_y] for c in ccs],
                   dtype=np.int32)
    x_hit = (cur[:, None, 0] <= boxes[None, :, 1]) & \
            (boxes[None, :, 0] <= cur[:, None, 1])
    y_hit = (cur[:, None, 2] <= boxes[None, :, 3]) & \
            (boxes[None, :, 2] <= cur[:, None, 3])
    return bool((x_hit & y_hit).any())


def _adopt_frame(left: CCTracker, frame: List[Tuple[int, CC]],
                 mapping: dict) -> None:
    """Apply one right-shard frame's local assignments to the merged state,
    mirroring add_frame_ccs' bookkeeping exactly."""
    from dataclasses import replace

    t = left.img_idx
    entries: List[Tuple[int, CC]] = []
    for local_uidx, cc in frame:
        merged_uidx = mapping.get(local_uidx)
        if merged_uidx is not None:
            left.unique_cc_frames[merged_uidx].append((t, cc.cc_id + 1))
            left._last_frame[merged_uidx] = t
            entries.append((merged_uidx, cc))
        else:
            merged_uidx = left._add_unique(cc)
            mapping[local_uidx] = merged_uidx
            entries.append((merged_uidx, cc))
    left._retire_inactive()
    if not left.keep_frame_masks:
        entries = [(uidx, replace(cc, img=None)) for uidx, cc in entries]
    left.cc_idx_per_frame.append(entries)
    left.img_idx += 1


# --------------------------------------------------------------- frontends

class StreamingShardedTracker:
    """Streaming sharded tracking for the express runner: each drained
    device batch becomes its own shard, extracted + locally tracked
    (optionally on worker processes) while later batches are still in
    flight, with completed shards fold-merged incrementally and in order.

    Shard-count invariance (merge_trackers is associative and exact) means
    batch-granular shards give the same bit-identical tracker as equal
    splits or sequential tracking — so streaming costs nothing in fidelity
    and keeps express wall-clock ≈ max(device binarize, host track /
    n_workers) instead of buffering the whole lecture before tracking
    starts."""

    def __init__(self, width: int, height: int, min_recall: float,
                 min_precision: float, max_gap: int, n_workers: int = 0,
                 chunk_frames: int = 0, keep_frame_masks: bool = True):
        """``chunk_frames`` > 0 accumulates at least that many frames per
        shard (coarser shards, less per-shard IPC/merge overhead); 0 makes
        each add_frames() call — i.e. each drained device batch — its own
        shard. Any granularity gives bit-identical results.
        ``keep_frame_masks=False`` runs the MERGED tracker slim (per-frame
        mask crops dropped once folded in; shard-local trackers still carry
        masks until their merge — bounded by one shard)."""
        self.params = (width, height, min_recall, min_precision, max_gap)
        self.keep_frame_masks = keep_frame_masks
        self.chunk_frames = chunk_frames
        self._buffer: list = []
        self._pool = None
        if n_workers > 1:
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(max_workers=n_workers)
        self._futures: list = []  # submission order == frame order
        self._merged: Optional[CCTracker] = None

    def add_frames(self, frames: Sequence[np.ndarray]) -> None:
        self._buffer.extend(frames)
        if not self._buffer or len(self._buffer) < self.chunk_frames:
            return
        work = (self._buffer,) + self.params
        self._buffer = []
        if self._pool is not None:
            self._futures.append(self._pool.submit(_shard_worker, work))
            # opportunistically fold finished prefix shards (cheap: adopt
            # fast path) so finish() isn't one big serial merge
            while self._futures and self._futures[0].done():
                self._merge(self._futures.pop(0).result())
        else:
            self._merge(_shard_worker(work))

    def _merge(self, tracker: CCTracker) -> None:
        if self._merged is None:
            self._merged = (tracker if self.keep_frame_masks
                            else slim_frame_masks(tracker))
        else:
            self._merged = merge_trackers(self._merged, tracker)

    def abort(self) -> None:
        """Release the worker pool without draining queued shards.

        For callers whose frame stream died mid-lecture (e.g. a device
        fetch timeout): queued shard jobs are cancelled; a shard already
        executing on a worker finishes, then the pool exits — so shutdown
        is delayed at most one shard, not by the whole queue (which is
        what concurrent.futures' atexit hook would otherwise wait on)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        self._futures.clear()
        self._buffer = []

    def finish(self) -> CCTracker:
        if self._buffer:  # flush the sub-chunk tail
            work = (self._buffer,) + self.params
            self._buffer = []
            if self._pool is not None:
                self._futures.append(self._pool.submit(_shard_worker, work))
            else:
                self._merge(_shard_worker(work))
        try:
            while self._futures:
                self._merge(self._futures.pop(0).result())
        finally:
            # a raising worker must not leak the pool or queued shards
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
                self._pool = None
            self._futures.clear()
        if self._merged is None:
            width, height, min_recall, min_precision, max_gap = self.params
            self._merged = CCTracker(width, height, min_recall,
                                     min_precision, max_gap,
                                     keep_frame_masks=self.keep_frame_masks)
        return self._merged


def _shard_worker(args):
    binaries, width, height, min_recall, min_precision, max_gap = args
    ccs_per_frame = [extract_ccs(frame) for frame in binaries]
    return track_shard(ccs_per_frame, width, height, min_recall,
                       min_precision, max_gap)


def track_sharded(binaries: Sequence[np.ndarray], min_recall: float = 0.925,
                  min_precision: float = 0.925, max_gap: int = 85,
                  n_shards: int = 0, n_workers: int = 0,
                  tree_reduce: bool = False,
                  keep_frame_masks: bool = True) -> CCTracker:
    """Shard the frame axis, track each shard (optionally on worker
    processes), and merge. Returns a tracker identical to the sequential
    CCTracker over all frames.

    ``n_shards`` <= 1 falls back to sequential tracking. ``n_workers`` > 1
    extracts+tracks shards on a process pool (DCN/host-level parallelism —
    the reference has no equivalent, SURVEY.md §2.11). ``tree_reduce``
    merges pairwise in log2(n_shards) levels instead of a left fold
    (exercises associativity; same result).
    """
    if len(binaries) == 0:
        raise ValueError("track_sharded: no frames to track (frame "
                         "dimensions are unknown for an empty input; the "
                         "streaming frontend handles empty lectures because "
                         "it is constructed with explicit dimensions)")
    height, width = binaries[0].shape
    params = (width, height, min_recall, min_precision, max_gap)

    if n_shards <= 1:
        tracker = CCTracker(width, height, min_recall, min_precision, max_gap,
                            keep_frame_masks=keep_frame_masks)
        for frame in binaries:
            tracker.add_frame(frame)
        return tracker

    bounds = np.linspace(0, len(binaries), n_shards + 1).astype(int)
    chunks = [binaries[bounds[k]:bounds[k + 1]] for k in range(n_shards)
              if bounds[k] < bounds[k + 1]]
    work = [(list(chunk),) + params for chunk in chunks]

    if n_workers > 1:
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(max_workers=n_workers) as pool:
            trackers = list(pool.map(_shard_worker, work))
    else:
        trackers = [_shard_worker(w) for w in work]

    if tree_reduce:
        # intermediate merges serve as RIGHT sides of later merges, so they
        # must keep masks — slim only the root, after the reduction
        while len(trackers) > 1:
            merged = [merge_trackers(trackers[k], trackers[k + 1])
                      if k + 1 < len(trackers) else trackers[k]
                      for k in range(0, len(trackers), 2)]
            trackers = merged
        return (trackers[0] if keep_frame_masks
                else slim_frame_masks(trackers[0]))

    result = trackers[0] if keep_frame_masks \
        else slim_frame_masks(trackers[0])
    for tracker in trackers[1:]:
        result = merge_trackers(result, tracker)
    return result
