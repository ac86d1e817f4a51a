"""Streaming unique-CC tracking and spatio-temporal grouping.

Behavioral contract follows the reference CCStabilityEstimator (reference:
AccessMath/preprocessing/content/cc_stability_estimator.py:10-748):

  * a per-frame CC is identified with an existing *active* unique CC when
    pixel recall and precision vs the unique CC's FIRST-SEEN mask are both
    above threshold; candidates are tried in ascending unique-index order
    and the first hit wins
  * unique CCs unseen for ``max_gap`` frames retire from the active set
  * stable CCs (>= min sightings) are grouped transitively when their masks
    overlap with recall above threshold within a temporal window
  * group conflicts accumulate matched/unmatched pixel counts and bbox
    union/intersection areas per group pair

The implementation is new: candidate generation is one vectorized bbox
intersection against the active table (replacing the dual IntervalIndex
sweep), and active-set state lives in growable numpy arrays.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.timing import span
from ..data.cc import CC, extract_ccs, render_ccs


class CCTracker:
    # class-level default so pre-existing pickled trackers (the stage-02
    # artifact stores the tracker itself) unpickle with full semantics
    keep_frame_masks = True

    def __init__(self, width: int, height: int, min_recall: float = 0.925,
                 min_precision: float = 0.925, max_gap: int = 85,
                 verbose: bool = False, keep_frame_masks: bool = True):
        self.width = width
        self.height = height
        self.min_recall = min_recall
        self.min_precision = min_precision
        self.max_gap = max_gap
        self.verbose = verbose
        # keep_frame_masks=False drops each frame's per-CC mask crops once
        # matching is done (stage-03 computations only ever read the
        # FIRST-SEEN masks in unique_ccs) — at full-lecture scale the
        # per-frame crops dominate RSS (~MBs/frame at 1080p), so the
        # streaming express/bench paths, which never pickle the tracker,
        # run slim. The staged stage-02 CLI keeps masks: its artifact IS
        # the tracker and the ST3D visualizer reads per-frame masks.
        self.keep_frame_masks = keep_frame_masks

        self.unique_ccs: List[CC] = []
        # per unique CC: list of (frame_idx, raw_label) sightings
        self.unique_cc_frames: List[List[Tuple[int, int]]] = []
        # per frame: list of (unique_idx, frame-local CC)
        self.cc_idx_per_frame: List[List[Tuple[int, CC]]] = []

        self._last_frame: List[int] = []
        self._active: List[int] = []          # unique indices, insertion order
        self._active_boxes = np.zeros((0, 4), dtype=np.int32)
        self.img_idx = 0
        self.candidates_tested = 0

    # ------------------------------------------------------------- tracking

    def add_frame(self, frame: np.ndarray, input_binary: bool = True) -> None:
        """Extract CCs from a frame and track them. With ``input_binary``
        False the frame is classically binarized first via background
        subtraction (reference: add_frame's non-binary default path,
        cc_stability_estimator.py:40-47)."""
        if not input_binary:
            from ..ops.classical import background_subtraction_binarize

            frame = background_subtraction_binarize(frame.astype(np.uint8))
        with span("stage02.extract", cpu=False):
            ccs = extract_ccs(frame)
        with span("stage02.match", cpu=False):
            self.add_frame_ccs(ccs)

    def add_frame_ccs(self, current: List[CC]) -> None:
        frame_entries: List[Tuple[int, CC]] = []

        if self.img_idx == 0 or not self._active:
            for cc in current:
                frame_entries.append((self._add_unique(cc), cc))
        else:
            self._match_frame(current, frame_entries)

        self._retire_inactive()
        if not self.keep_frame_masks:
            # slim copies only in the per-frame log — the first-sighting
            # object kept by _add_unique in unique_ccs stays intact
            # direct construction: dataclasses.replace re-runs field
            # introspection per call and was ~13% of tracking CPU at
            # full-lecture scale (one call per raw CC sighting)
            frame_entries = [(uidx, CC(cc.cc_id, cc.min_x, cc.max_x,
                                       cc.min_y, cc.max_y, cc.size, None,
                                       cc.start_time, cc.end_time))
                             for uidx, cc in frame_entries]
        self.cc_idx_per_frame.append(frame_entries)
        self.img_idx += 1

        if self.verbose:
            print(f"[{self.img_idx} ({len(current)}, {len(self.unique_ccs)})]",
                  end="\r")

    def _match_frame(self, current: List[CC],
                     frame_entries: List[Tuple[int, CC]]) -> None:
        active = np.asarray(self._active, dtype=np.int64)
        active_boxes = self._active_boxes

        if current:
            cur_boxes = np.array([[c.min_x, c.max_x, c.min_y, c.max_y]
                                  for c in current], dtype=np.int32)
            x_hit = (cur_boxes[:, None, 0] <= active_boxes[None, :, 1]) & \
                    (active_boxes[None, :, 0] <= cur_boxes[:, None, 1])
            y_hit = (cur_boxes[:, None, 2] <= active_boxes[None, :, 3]) & \
                    (active_boxes[None, :, 2] <= cur_boxes[:, None, 3])
            hits = x_hit & y_hit
        else:
            hits = np.zeros((0, len(active)), dtype=bool)

        # batch all candidate-pair overlap counts in one native call
        # (semantically identical to per-pair checks: acceptance is still
        # first-passing-candidate in ascending unique-index order).
        # ``_active`` is ascending by construction — uidx values are
        # append-only (_add_unique) and retirement preserves order — so
        # ``active[pair_cols]`` is already sorted within each row and the
        # per-row candidate list is a searchsorted slice, not a sort+dict.
        pair_rows, pair_cols = np.nonzero(hits)
        cand_unique = active[pair_cols]
        row_starts = np.searchsorted(pair_rows, np.arange(len(current) + 1))
        matched = None
        if len(pair_rows) > 8:
            from .. import native

            if native.available():
                packed_prev = native.PackedMasks(
                    [self.unique_ccs[u] for u in cand_unique])
                packed_cur = native.PackedMasks(current)
                matched = native.batch_overlap(
                    packed_cur, packed_prev,
                    np.stack([pair_rows, np.arange(len(pair_rows))], axis=1))

        cand_list = cand_unique.tolist()
        for cur_idx, cc in enumerate(current):
            # candidate unique indices in ascending order (matches the
            # reference's sorted merge of interval-index hits)
            lo, hi = int(row_starts[cur_idx]), int(row_starts[cur_idx + 1])
            self.candidates_tested += hi - lo
            found = None
            for k in range(lo, hi):
                uidx = cand_list[k]
                prev_cc = self.unique_ccs[uidx]
                if matched is not None:
                    match = int(matched[k])
                    recall = match / float(cc.size)
                    precision = match / float(prev_cc.size)
                else:
                    recall, precision = cc.overlap_recall_precision(prev_cc)
                if recall >= self.min_recall and precision >= self.min_precision:
                    found = int(uidx)
                    break

            if found is not None:
                self.unique_cc_frames[found].append((self.img_idx, cc.cc_id + 1))
                self._last_frame[found] = self.img_idx
                frame_entries.append((found, cc))
            else:
                frame_entries.append((self._add_unique(cc), cc))

    def _add_unique(self, cc: CC) -> int:
        uidx = len(self.unique_ccs)
        self.unique_ccs.append(cc)
        self.unique_cc_frames.append([(self.img_idx, cc.cc_id + 1)])
        self._last_frame.append(self.img_idx)
        self._active.append(uidx)
        self._active_boxes = np.concatenate(
            [self._active_boxes,
             np.array([[cc.min_x, cc.max_x, cc.min_y, cc.max_y]], np.int32)])
        return uidx

    def _retire_inactive(self) -> None:
        if not self._active:
            return
        keep = [self.img_idx - self._last_frame[uidx] < self.max_gap
                for uidx in self._active]
        if not all(keep):
            keep = np.asarray(keep)
            self._active = [u for u, k in zip(self._active, keep) if k]
            self._active_boxes = self._active_boxes[keep]

    # ------------------------------------------------------ stage-03 queries

    def raw_cc_count(self) -> int:
        return sum(len(frame) for frame in self.cc_idx_per_frame)

    def temporal_index(self) -> List[List[int]]:
        """Per-frame unique-CC index lists (reference: get_temporal_index,
        cc_stability_estimator.py:238-243)."""
        return [[uidx for uidx, _ in frame] for frame in self.cc_idx_per_frame]

    def rebuilt_binary_frames(self) -> List[np.ndarray]:
        if not self.keep_frame_masks:
            raise ValueError(
                "per-frame masks were dropped (keep_frame_masks=False) — "
                "rebuild requires a tracker built with keep_frame_masks=True")
        return [render_ccs([cc for _, cc in frame], self.height, self.width)
                for frame in self.cc_idx_per_frame]

    def split_stable_by_gaps(self, max_gap: int, stable_min_frames: int) -> int:
        """Split a unique CC whose sighting list has gaps > max_gap into one
        unique CC per contiguous run (reference: split_stable_cc_by_gaps,
        cc_stability_estimator.py:181-228)."""
        split_count = 0
        n_original = len(self.unique_ccs)
        for uidx in range(n_original):
            sightings = self.unique_cc_frames[uidx]
            runs: List[List[Tuple[int, int]]] = [[sightings[0]]]
            for prev, cur in zip(sightings, sightings[1:]):
                if cur[0] - prev[0] > max_gap:
                    runs.append([cur])
                else:
                    runs[-1].append(cur)

            if len(runs) >= 2 and len(sightings) >= stable_min_frames:
                self.unique_cc_frames[uidx] = runs[0]
                for run in runs[1:]:
                    new_uidx = len(self.unique_ccs)
                    self.unique_ccs.append(self.unique_ccs[uidx])
                    self.unique_cc_frames.append(run)
                    # one renumbering per SIGHTING, not per frame: a frame
                    # where two CCs matched the same unique CC has two
                    # entries with this uidx, and the reference renumbers
                    # both (the break lands on the next one each pass)
                    for frame_idx, _ in run:
                        frame = self.cc_idx_per_frame[frame_idx]
                        for offset, (entry_uidx, local_cc) in enumerate(frame):
                            if entry_uidx == uidx:
                                frame[offset] = (new_uidx, local_cc)
                                break
                split_count += 1
        return split_count

    def stable_cc_idxs(self, min_stable_frames: int) -> List[int]:
        return [uidx for uidx in range(len(self.unique_ccs))
                if len(self.unique_cc_frames[uidx]) >= min_stable_frames]

    def compute_overlapping_stable(self, stable_idxs: Sequence[int],
                                   temporal_window: int):
        """All-pairs spatial overlap among stable CCs.

        Returns (time_overlapping, total_time_pairs, all_overlapping):
          * all_overlapping[u]  = [(other, matched_px, other_size, own_size)]
          * time_overlapping[u] = [(other, recall, precision)] for pairs that
            also overlap in time within the window
        (reference: compute_overlapping_stable_cc, :245-306)
        """
        n_objects = len(self.unique_ccs)
        all_overlapping: List[List[tuple]] = [[] for _ in range(n_objects)]
        time_overlapping: List[List[tuple]] = [[] for _ in range(n_objects)]
        total_time_pairs = 0

        stable = np.asarray(sorted(stable_idxs), dtype=np.int64)
        if len(stable) == 0:
            return time_overlapping, 0, all_overlapping

        boxes = np.array([[self.unique_ccs[u].min_x, self.unique_ccs[u].max_x,
                           self.unique_ccs[u].min_y, self.unique_ccs[u].max_y]
                          for u in stable], dtype=np.int32)
        x_hit = (boxes[:, None, 0] <= boxes[None, :, 1]) & \
                (boxes[None, :, 0] <= boxes[:, None, 1])
        y_hit = (boxes[:, None, 2] <= boxes[None, :, 3]) & \
                (boxes[None, :, 2] <= boxes[:, None, 3])
        hits = np.triu(x_hit & y_hit, k=1)
        pair_a, pair_b = np.nonzero(hits)

        starts = {int(u): self.unique_cc_frames[u][0][0] for u in stable}
        ends = {int(u): self.unique_cc_frames[u][-1][0] for u in stable}

        # all-pairs matched-pixel counts in one native call (the stage-03
        # hot loop; pure-python fallback below preserves exact semantics)
        matched_counts = None
        if len(pair_a) > 8:
            from .. import native

            if native.available():
                packed = native.PackedMasks([self.unique_ccs[u] for u in stable])
                matched_counts = native.batch_overlap(
                    packed, packed, np.stack([pair_a, pair_b], axis=1))

        for pair_idx, (offset_a, offset_b) in enumerate(zip(pair_a, pair_b)):
            u1 = int(stable[offset_a])
            u2 = int(stable[offset_b])
            cc1 = self.unique_ccs[u1]
            cc2 = self.unique_ccs[u2]
            if matched_counts is not None:
                match = int(matched_counts[pair_idx])
                recall = match / float(cc1.size)
                precision = match / float(cc2.size)
            else:
                recall, precision = cc1.overlap_recall_precision(cc2)
            if recall > 0.0 or precision > 0.0:
                matched = int(round(cc1.size * recall))
                all_overlapping[u1].append((u2, matched, cc2.size, cc1.size))
                all_overlapping[u2].append((u1, matched, cc1.size, cc2.size))

                if (ends[u1] + temporal_window >= starts[u2] and
                        ends[u2] >= starts[u1] - temporal_window):
                    time_overlapping[u1].append((u2, recall, precision))
                    time_overlapping[u2].append((u1, precision, recall))
                    total_time_pairs += 1

        return time_overlapping, total_time_pairs, all_overlapping

    def compute_groups(self, stable_idxs: Sequence[int],
                       time_overlapping: List[List[tuple]],
                       min_recall: float):
        """Transitive grouping of time+space overlapping stable CCs
        (reference: compute_groups, :308-413). Returns (groups,
        group_idx_per_cc) with group numbering in creation order."""
        groups: List[List[int]] = []
        group_of: Dict[int, int] = {}

        for u1 in stable_idxs:
            if u1 in group_of:
                gidx = group_of[u1]
            else:
                gidx = len(groups)
                groups.append([u1])
                group_of[u1] = gidx

            for u2, recall, _precision in time_overlapping[u1]:
                if recall < min_recall:
                    continue
                if u2 not in group_of:
                    group_of[u2] = gidx
                    groups[gidx].append(u2)
                else:
                    other = group_of[u2]
                    if other != gidx:
                        for member in groups[other]:
                            group_of[member] = gidx
                            groups[gidx].append(member)
                        groups[other] = []

        final_groups: List[List[int]] = []
        final_group_of: Dict[int, int] = {}
        for group in groups:
            if group:
                new_idx = len(final_groups)
                final_groups.append(group)
                for member in group:
                    final_group_of[member] = new_idx
        return final_groups, final_group_of

    def compute_group_ages(self, groups: List[List[int]]):
        """Per-group sorted age breakpoints + groups active per frame
        (reference: compute_groups_temporal_information, :415-444)."""
        n_frames = len(self.cc_idx_per_frame)
        group_ages: Dict[int, List[int]] = {}
        groups_per_frame: List[List[int]] = [[] for _ in range(n_frames)]

        for gidx, group in enumerate(groups):
            if not group:
                continue
            ages: List[int] = []
            for uidx in group:
                for bound in (self.unique_cc_frames[uidx][0][0],
                              self.unique_cc_frames[uidx][-1][0]):
                    if bound not in ages:
                        ages.append(bound)
            ages.sort()
            group_ages[gidx] = ages
            for frame_idx in range(ages[0], min(ages[-1] + 1, n_frames)):
                groups_per_frame[frame_idx].append(gidx)

        return group_ages, groups_per_frame

    def compute_conflicts(self, stable_idxs: Sequence[int],
                          all_overlapping: List[List[tuple]],
                          n_groups: int, group_of: Dict[int, int]):
        """Accumulate cross-group conflict stats per group pair
        (reference: compute_conflicting_groups, :446-500)."""
        conflicts: Dict[int, Dict[int, Dict[str, float]]] = \
            {g: {} for g in range(n_groups)}

        for u1 in stable_idxs:
            cc1 = self.unique_ccs[u1]
            for u2, matched, size2, size1 in all_overlapping[u1]:
                if u1 >= u2:
                    continue
                cc2 = self.unique_ccs[u2]
                g1 = group_of[u1]
                g2 = group_of[u2]
                if g1 == g2:
                    continue

                unmatched = size1 + size2 - matched * 2
                inter = cc1.overlap_area(cc2)
                union = cc1.box_area() + cc2.box_area() - inter

                for ga, gb in ((g1, g2), (g2, g1)):
                    entry = conflicts[ga].setdefault(gb, {
                        "matched": 0, "unmatched": 0,
                        "area_union": 0, "area_intersection": 0})
                    entry["matched"] += matched
                    entry["unmatched"] += unmatched
                    entry["area_union"] += union
                    entry["area_intersection"] += inter

        return conflicts

    def compute_group_images(self, groups: List[List[int]],
                             group_ages: Dict[int, List[int]],
                             segment_threshold: float):
        """Per-age-segment majority mask for each group
        (reference: compute_group_images, :575-636): each member CC's mask is
        added once per sighting inside the segment; pixels at >= threshold
        fraction of the max vote survive."""
        group_images: Dict[int, List[np.ndarray]] = {}
        group_boundaries: Dict[int, tuple] = {}

        for gidx, group in enumerate(groups):
            if not group:
                continue
            members = [self.unique_ccs[u] for u in group]
            g_min_x = min(cc.min_x for cc in members)
            g_max_x = max(cc.max_x for cc in members)
            g_min_y = min(cc.min_y for cc in members)
            g_max_y = max(cc.max_y for cc in members)
            group_boundaries[gidx] = (g_min_x, g_max_x, g_min_y, g_max_y)

            g_h = g_max_y - g_min_y + 1
            g_w = g_max_x - g_min_x + 1
            ages = group_ages[gidx]

            images = []
            for t_start, t_end in zip(ages, ages[1:]):
                votes = np.zeros((g_h, g_w), dtype=np.int32)
                for uidx, cc in zip(group, members):
                    n_sightings = sum(1 for f, _ in self.unique_cc_frames[uidx]
                                      if t_start <= f <= t_end)
                    if n_sightings > 0:
                        oy = cc.min_y - g_min_y
                        ox = cc.min_x - g_min_x
                        votes[oy:oy + cc.height, ox:ox + cc.width] += \
                            (cc.img // 255).astype(np.int32) * n_sightings
                max_votes = votes.max()
                if max_votes == 0:
                    images.append(np.zeros((g_h, g_w), dtype=np.uint8))
                else:
                    mask = (votes.astype(np.float64) / max_votes) >= segment_threshold
                    images.append(mask.astype(np.uint8) * 255)

            group_images[gidx] = images

        return group_images, group_boundaries

    def iter_clean_frames_from_groups(self, groups: List[List[int]],
                                      group_boundaries: Dict[int, tuple],
                                      groups_per_frame: List[List[int]],
                                      group_ages: Dict[int, List[int]],
                                      group_images: Dict[int,
                                                         List[np.ndarray]]):
        """Re-render per-frame clean binary (stable grouped content only),
        one frame at a time (reference: frames_from_groups, :638-681).

        A generator so full-lecture consumers (express ``save_artifacts``,
        the cc_grouping stage) can PNG-compress each frame as it is
        produced instead of materializing the whole uncompressed cube
        (~1.9 GB at 3,600x960x540, ~7.5 GB at 1080p)."""
        next_segment = {gidx: 0 for gidx in group_ages}

        for img_idx, frame_groups in enumerate(groups_per_frame):
            frame = np.zeros((self.height, self.width), dtype=np.uint8)
            for gidx in frame_groups:
                ages = group_ages[gidx]
                while ages[next_segment[gidx] + 1] < img_idx:
                    next_segment[gidx] += 1
                segment_img = group_images[gidx][next_segment[gidx]]
                g_min_x, g_max_x, g_min_y, g_max_y = group_boundaries[gidx]
                frame[g_min_y:g_max_y + 1, g_min_x:g_max_x + 1] += segment_img
            yield frame

    def clean_frames_from_groups(self, groups: List[List[int]],
                                 group_boundaries: Dict[int, tuple],
                                 groups_per_frame: List[List[int]],
                                 group_ages: Dict[int, List[int]],
                                 group_images: Dict[int, List[np.ndarray]]
                                 ) -> List[np.ndarray]:
        """List form of :meth:`iter_clean_frames_from_groups`."""
        return list(self.iter_clean_frames_from_groups(
            groups, group_boundaries, groups_per_frame, group_ages,
            group_images))


def compute_overlapping_cc_groups(ccs: Sequence[CC]):
    """Transitive spatial-overlap grouping of a CC list (used to resolve
    keyframe conflicts; reference: compute_overlapping_CC_groups, :697-748).

    Returns (overlapping_groups, singletons) as lists of indices into ``ccs``.
    """
    n = len(ccs)
    adjacency: List[List[int]] = [[] for _ in range(n)]
    if n:
        boxes = np.array([[c.min_x, c.max_x, c.min_y, c.max_y] for c in ccs],
                         dtype=np.int32)
        x_hit = (boxes[:, None, 0] <= boxes[None, :, 1]) & \
                (boxes[None, :, 0] <= boxes[:, None, 1])
        y_hit = (boxes[:, None, 2] <= boxes[None, :, 3]) & \
                (boxes[None, :, 2] <= boxes[:, None, 3])
        pair_a, pair_b = np.nonzero(np.triu(x_hit & y_hit, k=1))
        for i, j in zip(pair_a, pair_b):
            recall, precision = ccs[i].overlap_recall_precision(ccs[j])
            if recall > 0.0 or precision > 0.0:
                adjacency[i].append(int(j))
                adjacency[j].append(int(i))

    # connected components of the overlap graph
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in adjacency[i]:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[rj] = ri

    components: Dict[int, List[int]] = {}
    for i in range(n):
        components.setdefault(find(i), []).append(i)

    overlapping_groups = [members for members in components.values()
                          if len(members) > 1]
    singletons = [members[0] for members in components.values()
                  if len(members) == 1]
    return overlapping_groups, singletons
