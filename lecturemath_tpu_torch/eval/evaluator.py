"""Summary evaluation: CC-level matching of summary keyframes against
ground-truth keyframes, plus pixel-level metrics.

Metric semantics follow the reference Evaluator
(reference: AccessMath/evaluation/evaluator.py:18-1015):

  * overlapping GT/summary segments pair their keyframes; each pair is
    globally aligned (translation, recall-maximizing)
  * overlapping CCs merge transitively into candidate match groups; 1:1
    groups classify as exact matches, n:m groups as partial matches, when
    recall AND precision of the (merged) masks pass thresholds
  * recall rolls up over GT unique-CC groups (global + per-frame);
    precision over summary CCs per keyframe, with a background-overlap
    discount (no_bg_precision)
  * the whole grid of (min_recall, min_precision) thresholds and CC-size
    percentile ranges is reported

Keyframe alignments run batched through the FFT aligner instead of a
6-process pool scanning 441 displacements each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.cc import CC, merge_ccs
from .aligner import AlignInfo, translation_alignment
from .annotation import cc_str_id


@dataclass
class EvalParams:
    """(reference: eval_parameters.py:3-20)"""
    global_translation_window: int = 10
    local_translation_window: int = 3
    min_translation_fscore: float = 0.3
    min_cc_precision: Tuple[float, ...] = (0.50, 0.65, 0.80, 0.95)
    min_cc_recall: Tuple[float, ...] = (0.50, 0.65, 0.80, 0.95)
    size_percentiles: Tuple[int, ...] = (10, 25, 75)
    min_align_recall: float = 0.05
    show_counts: bool = True
    show_avg_per_frame: bool = True
    show_globals: bool = True
    show_stats_per_size: bool = True


class CCMatch:
    """A candidate match group between GT (frame1) and summary (frame2) CCs
    (reference: cc_match_info.py)."""

    def __init__(self, frame1_ccs=None, frame2_ccs=None):
        self.frame1_ccs: List[CC] = list(frame1_ccs or [])
        self.frame2_ccs: List[CC] = list(frame2_ccs or [])

    def is_exact_shape(self) -> bool:
        return len(self.frame1_ccs) == 1 and len(self.frame2_ccs) == 1

    @staticmethod
    def merge(a: "CCMatch", b: "CCMatch") -> "CCMatch":
        f1 = {id(cc): cc for cc in a.frame1_ccs + b.frame1_ccs}
        f2 = {id(cc): cc for cc in a.frame2_ccs + b.frame2_ccs}
        return CCMatch(list(f1.values()), list(f2.values()))


def _shift(cc: CC, dx: int, dy: int) -> CC:
    return CC(cc.cc_id, cc.min_x + dx, cc.max_x + dx, cc.min_y + dy,
              cc.max_y + dy, cc.size, cc.img)


class Evaluator:
    def __init__(self, params: Optional[EvalParams] = None):
        self.params = params or EvalParams()

    # ----------------------------------------------------- overlap stage

    @staticmethod
    def overlapping_cc_groups(gt_ccs: Sequence[CC], summ_ccs: Sequence[CC],
                              alignment: AlignInfo) -> List[CCMatch]:
        """Transitive merge of pixel-overlapping CC pairs under the global
        alignment (reference: keyframes_overlapping_ccs, :168-218)."""
        _, _, _, disp_y, disp_x = alignment

        group_of_f1: Dict[int, CCMatch] = {id(cc): CCMatch([cc], [])
                                           for cc in gt_ccs}
        group_of_f2: Dict[int, CCMatch] = {id(cc): CCMatch([], [cc])
                                           for cc in summ_ccs}

        # candidate pairs via one bbox-intersection matrix, matched-pixel
        # counts via one native batch call (pairwise_overlap falls back to
        # exact per-pair python); a pair connects when >= 1 pixel matches
        # (the reference's recall > 0 test, :181)
        from ..ops.overlap import candidate_pairs, pairwise_overlap

        shifted_summ = [_shift(cc, disp_x, disp_y) for cc in summ_ccs]
        pairs = candidate_pairs(list(gt_ccs), shifted_summ)
        matches = pairwise_overlap(list(gt_ccs), shifted_summ, pairs)

        for (g_idx, s_idx), match_count in zip(pairs, matches):
            if match_count > 0:
                match1 = group_of_f1[id(gt_ccs[g_idx])]
                match2 = group_of_f2[id(summ_ccs[s_idx])]
                if match1 is not match2:
                    merged = CCMatch.merge(match1, match2)
                    for cc in merged.frame1_ccs:
                        group_of_f1[id(cc)] = merged
                    for cc in merged.frame2_ccs:
                        group_of_f2[id(cc)] = merged

        unique = {id(m): m for m in group_of_f1.values()}
        unique.update({id(m): m for m in group_of_f2.values()})
        return list(unique.values())

    @staticmethod
    def classify_matches(overlap_set: Sequence[CCMatch], alignment: AlignInfo,
                         min_recall: float, min_precision: float):
        """Exact vs partial vs unmatched classification
        (reference: match_overlapping_ccs, :220-282)."""
        _, _, _, disp_y, disp_x = alignment
        exact, partial = [], []
        unmatched_gt: List[CC] = []
        unmatched_summ: List[CC] = []

        for match in overlap_set:
            if not match.frame1_ccs:
                unmatched_summ += match.frame2_ccs
            elif not match.frame2_ccs:
                unmatched_gt += match.frame1_ccs
            else:
                if match.is_exact_shape():
                    gt_side = match.frame1_ccs[0]
                    summ_side = _shift(match.frame2_ccs[0], disp_x, disp_y)
                else:
                    gt_side = merge_ccs(match.frame1_ccs)
                    summ_side = _shift(merge_ccs(match.frame2_ccs),
                                       disp_x, disp_y)
                recall, precision = gt_side.overlap_recall_precision(summ_side)
                if recall >= min_recall and precision >= min_precision:
                    (exact if match.is_exact_shape() else partial).append(match)
                else:
                    unmatched_gt += match.frame1_ccs
                    unmatched_summ += match.frame2_ccs

        return exact, partial, unmatched_gt, unmatched_summ

    # ------------------------------------------------- segment-level stage

    def summary_overlapping_ccs(self, gt_segments, gt_keyframes,
                                summ_segments, summ_keyframes,
                                verbose: bool = False):
        """Pair temporally-overlapping segments, align their keyframes, and
        collect overlap groups + background overlaps
        (reference: summary_overlapping_ccs, :314-380)."""
        params = self.params
        pairs = []
        gt_idx = summ_idx = 0
        while gt_idx < len(gt_segments) and summ_idx < len(summ_segments):
            if (gt_segments[gt_idx][0] < summ_segments[summ_idx][1] and
                    summ_segments[summ_idx][0] < gt_segments[gt_idx][1]):
                pairs.append((gt_idx, summ_idx))
            if summ_segments[summ_idx][1] < gt_segments[gt_idx][1]:
                summ_idx += 1
            else:
                gt_idx += 1

        all_overlaps = []
        bg_overlaps = [{cc_str_id(cc): 0 for cc in kf.binary_cc}
                       for kf in summ_keyframes]

        for gt_idx, summ_idx in pairs:
            gt_bin = gt_keyframes[gt_idx].binary_image[:, :, 0]
            summ_bin = summ_keyframes[summ_idx].binary_image[:, :, 0]
            align = translation_alignment(gt_bin, summ_bin,
                                          params.global_translation_window,
                                          0, sort_by=1)
            if align[1] < params.min_align_recall:
                if verbose:
                    print(f"pair ({gt_idx},{summ_idx}): recall too low, skip")
                continue

            overlap_set = self.overlapping_cc_groups(
                gt_keyframes[gt_idx].binary_cc,
                summ_keyframes[summ_idx].binary_cc, align)

            gt_kf = gt_keyframes[gt_idx]
            for cc in summ_keyframes[summ_idx].binary_cc:
                if gt_kf.check_cc_overlaps_background(cc, align[4], align[3]):
                    bg_overlaps[summ_idx][cc_str_id(cc)] += 1

            all_overlaps.append((gt_idx, summ_idx, align, overlap_set))

        return all_overlaps, bg_overlaps

    @staticmethod
    def collect_matches(gt_keyframes, gt_groups, gt_cc_group, summ_keyframes,
                        all_overlaps, min_recall, min_precision):
        """Assign classified matches to unique-CC groups / per-frame tables
        (reference: find_gt_unique_cc_matches, :382-435)."""
        summ_matches = [{cc_str_id(cc): [] for cc in kf.binary_cc}
                        for kf in summ_keyframes]
        gt_matches = {group.str_id(): [] for group in gt_groups}
        frame_gt_matches = [{cc_str_id(cc): [] for cc in kf.binary_cc}
                            for kf in gt_keyframes]

        for gt_idx, summ_idx, align, overlap_set in all_overlaps:
            exact, partial, _, _ = Evaluator.classify_matches(
                overlap_set, align, min_recall, min_precision)
            for match in exact + partial:
                for cc in match.frame1_ccs:
                    group = gt_cc_group[gt_idx][cc_str_id(cc)]
                    gt_matches[group.str_id()].append(match)
                    frame_gt_matches[gt_idx][cc_str_id(cc)].append(match)
                for cc in match.frame2_ccs:
                    summ_matches[summ_idx][cc_str_id(cc)].append(match)

        return gt_matches, frame_gt_matches, summ_matches

    # ------------------------------------------------------ metric rollups

    @staticmethod
    def _match_type_counts(match_lists) -> Tuple[int, int, int]:
        exact = partial = unmatched = 0
        for matches in match_lists:
            if not matches:
                unmatched += 1
            elif any(m.is_exact_shape() for m in matches):
                exact += 1
            else:
                partial += 1
        return exact, partial, unmatched

    @staticmethod
    def recall_metrics(gt_matches: Dict[str, list],
                       frame_gt_matches: List[Dict[str, list]]):
        """(reference: compute_unique_cc_summary_metrics, :486-541)"""
        exact, partial, unmatched = Evaluator._match_type_counts(
            gt_matches.values())
        total = len(gt_matches)

        per_frame = {"exact": [], "partial": [], "all": []}
        for frame in frame_gt_matches:
            f_exact, f_partial, f_unmatched = Evaluator._match_type_counts(
                frame.values())
            f_total = f_exact + f_partial + f_unmatched
            if f_total > 0:
                per_frame["exact"].append(f_exact / f_total)
                per_frame["partial"].append(f_partial / f_total)
                per_frame["all"].append((f_exact + f_partial) / f_total)

        def mean(values):
            return float(np.mean(values)) if values else 0.0

        return {
            "count": total,
            "recall": (exact + partial) / total if total else 0.0,
            "only_exact_recall": exact / total if total else 0.0,
            "only_partial_recall": partial / total if total else 0.0,
            "avg_recall": mean(per_frame["all"]),
            "avg_only_exact_recall": mean(per_frame["exact"]),
            "avg_only_partial_recall": mean(per_frame["partial"]),
            "exact_matches": exact,
            "partial_matches": partial,
            "unmatched": unmatched,
        }

    @staticmethod
    def precision_metrics(summ_matches: List[Dict[str, list]],
                          bg_overlaps: List[Dict[str, int]]):
        """(reference: compute_per_frame_summary_metrics, :543-649)"""
        per_kf = {"exact": [], "partial": [], "unmatched": [], "bg": []}
        avg = {"exact": [], "partial": [], "all": [], "bg_prc": [], "no_bg": []}
        total_count = 0

        for kf_idx, frame in enumerate(summ_matches):
            f_exact, f_partial, f_unmatched = Evaluator._match_type_counts(
                frame.values())
            f_bg = sum(1 for cc_id, matches in frame.items()
                       if not matches and bg_overlaps[kf_idx].get(cc_id, 0) > 0)

            per_kf["exact"].append(f_exact)
            per_kf["partial"].append(f_partial)
            per_kf["unmatched"].append(f_unmatched)
            per_kf["bg"].append(f_bg)

            f_total = f_exact + f_partial + f_unmatched
            total_count += f_total
            if f_total > 0:
                avg["exact"].append(f_exact / f_total)
                avg["partial"].append(f_partial / f_total)
                avg["all"].append((f_exact + f_partial) / f_total)
            else:
                avg["exact"].append(1.0)
                avg["partial"].append(0.0)
                avg["all"].append(1.0)

            no_bg_total = f_total - f_bg
            avg["no_bg"].append((f_exact + f_partial) / no_bg_total
                                if no_bg_total > 0 else 0.0)
            avg["bg_prc"].append(f_bg / f_unmatched if f_unmatched > 0 else 0.0)

        total_exact = sum(per_kf["exact"])
        total_partial = sum(per_kf["partial"])
        total_unmatched = sum(per_kf["unmatched"])
        total_bg = sum(per_kf["bg"])

        def ratio(num, den):
            return num / den if den > 0 else 0.0

        def mean(values):
            return float(np.mean(values)) if values else 0.0

        return {
            "count": total_count,
            "precision": ratio(total_exact + total_partial, total_count),
            "only_exact_precision": ratio(total_exact, total_count),
            "only_partial_precision": ratio(total_partial, total_count),
            "no_bg_precision": ratio(total_exact + total_partial,
                                     total_count - total_bg),
            "global_bg_unmatched": ratio(total_bg, total_unmatched),
            "avg_precision": mean(avg["all"]),
            "avg_only_exact_precision": mean(avg["exact"]),
            "avg_only_partial_precision": mean(avg["partial"]),
            "avg_prc_bg_not_matched": mean(avg["bg_prc"]),
            "avg_no_bg_precision": mean(avg["no_bg"]),
            "exact_matches": per_kf["exact"],
            "partial_matches": per_kf["partial"],
            "unmatched": per_kf["unmatched"],
            "bg_unmatched": per_kf["bg"],
            "all_precision": avg["all"],
            "all_only_exact_precision": avg["exact"],
            "all_only_partial_precision": avg["partial"],
            "all_no_bg_precision": avg["no_bg"],
        }

    @staticmethod
    def filter_by_size(gt_keyframes, gt_groups, gt_matches, frame_gt_matches,
                       summ_keyframes, summ_matches, bound_min, bound_max):
        """(reference: filter_matches_per_size, :651-676)"""
        groups_by_id = {group.str_id(): group for group in gt_groups}
        f_gt = {gid: m for gid, m in gt_matches.items()
                if bound_min <= groups_by_id[gid].cc_refs[0].size < bound_max}

        f_frame_gt = []
        for kf_idx, keyframe in enumerate(gt_keyframes):
            f_frame_gt.append({cc_str_id(cc): frame_gt_matches[kf_idx][cc_str_id(cc)]
                               for cc in keyframe.binary_cc
                               if bound_min <= cc.size < bound_max})

        f_summ = []
        for kf_idx, keyframe in enumerate(summ_keyframes):
            f_summ.append({cc_str_id(cc): summ_matches[kf_idx][cc_str_id(cc)]
                           for cc in keyframe.binary_cc
                           if bound_min <= cc.size < bound_max})

        return f_gt, f_frame_gt, f_summ

    # ------------------------------------------------------- entry points

    def compute_summary_metrics(self, gt_segments, gt_keyframes, gt_groups,
                                gt_cc_group, summ_segments, summ_keyframes,
                                verbose: bool = False):
        """(reference: compute_summary_metrics, :700-776). Note: min R/P
        threshold pairs are ZIPPED, not cross-producted, like the
        reference (:725)."""
        params = self.params

        all_sizes = np.array([group.cc_refs[0].size for group in gt_groups])
        size_boundaries = [0]
        if params.show_stats_per_size and len(all_sizes):
            for percentile in params.size_percentiles:
                size_boundaries.append(int(round(np.percentile(all_sizes,
                                                               percentile))))
            size_boundaries.append(int(all_sizes.max()) + 1)

        all_overlaps, bg_overlaps = self.summary_overlapping_ccs(
            gt_segments, gt_keyframes, summ_segments, summ_keyframes, verbose)

        metrics: Dict[str, list] = {}
        range_names: List[str] = []
        for min_r, min_p in zip(params.min_cc_recall, params.min_cc_precision):
            gt_matches, frame_gt_matches, summ_matches = self.collect_matches(
                gt_keyframes, gt_groups, gt_cc_group, summ_keyframes,
                all_overlaps, min_r, min_p)

            for range_idx in range(len(size_boundaries)):
                if range_idx == len(size_boundaries) - 1:
                    range_name = "all"
                    r_gt, r_frame_gt, r_summ = (gt_matches, frame_gt_matches,
                                                summ_matches)
                else:
                    lo = size_boundaries[range_idx]
                    hi = size_boundaries[range_idx + 1]
                    range_name = f"[{lo}, {hi})"
                    r_gt, r_frame_gt, r_summ = self.filter_by_size(
                        gt_keyframes, gt_groups, gt_matches, frame_gt_matches,
                        summ_keyframes, summ_matches, lo, hi)

                entry = {
                    "min_cc_recall": min_r,
                    "min_cc_precision": min_p,
                    "recall_metrics": self.recall_metrics(r_gt, r_frame_gt),
                    "precision_metrics": self.precision_metrics(r_summ,
                                                                bg_overlaps),
                }
                if range_name not in metrics:
                    range_names.append(range_name)
                    metrics[range_name] = []
                metrics[range_name].append(entry)

        return metrics, range_names

    @staticmethod
    def compute_pixel_binary_metrics(gt_keyframes, summ_keyframes):
        """Pixel recall/precision/f + board-only variants
        (reference: compute_pixel_binary_metrics, :964-1015)."""
        rollup = {"recall": [], "precision": [], "fmeasure": [],
                  "board_precision": [], "board_fmeasure": []}

        for gt_kf, summ_kf in zip(gt_keyframes, summ_keyframes):
            gt_ink = 255 - gt_kf.binary_image[:, :, 0]
            summ_ink = 255 - summ_kf.binary_image[:, :, 0]

            total_gt = gt_ink.sum() / 255
            total_summ = summ_ink.sum() / 255
            correct = summ_ink[gt_ink > 0].sum() / 255

            board_only = summ_ink.copy()
            board_only[gt_kf.object_mask] = 0
            total_board = board_only.sum() / 255

            recall = correct / total_gt if total_gt else 0.0
            precision = correct / total_summ if total_summ else 0.0
            board_precision = (correct / total_board if total_board > 0
                               else 1.0)

            def fscore(r, p):
                return 2.0 * r * p / (r + p) if r + p > 0 else 0.0

            rollup["recall"].append(recall)
            rollup["precision"].append(precision)
            rollup["fmeasure"].append(fscore(recall, precision))
            rollup["board_precision"].append(board_precision)
            rollup["board_fmeasure"].append(fscore(recall, board_precision))

        return {key: float(np.mean(values)) for key, values in rollup.items()}

    # --------------------------------------------------------- reporting

    def print_recall_tables(self, scope_metrics, scope: str) -> None:
        """Per-threshold GT-match tables (reference:
        print_summary_recall_metrics, evaluator.py:778-813)."""
        if self.params.show_counts:
            print(f"Matching Params\t|\tGround Truth Matches (Count - {scope})")
            print("Min. R.\tMin. P.\t|\tE + P\t|\tE. Only\tP. Only\tMiss\tTotal")
            for entry in scope_metrics:
                r = entry["recall_metrics"]
                print(f"{entry['min_cc_recall'] * 100:.2f}\t"
                      f"{entry['min_cc_precision'] * 100:.2f}\t|\t"
                      f"{r['exact_matches'] + r['partial_matches']}\t|\t"
                      f"{r['exact_matches']}\t{r['partial_matches']}\t"
                      f"{r['unmatched']}\t{r['count']}")
        for flag, title, keys in (
                (self.params.show_avg_per_frame, "Per Frame Recall",
                 ("avg_recall", "avg_only_exact_recall",
                  "avg_only_partial_recall")),
                (self.params.show_globals, "Unique CC Recall",
                 ("recall", "only_exact_recall", "only_partial_recall"))):
            if not flag:
                continue
            print(f"\nMatching Params\t|\tGround Truth Matches "
                  f"({title} - {scope})")
            print("Min. R.\tMin. P.\t|\tE + P\t|\tE. Only\tP. Only")
            for entry in scope_metrics:
                r = entry["recall_metrics"]
                print(f"{entry['min_cc_recall'] * 100:.2f}\t"
                      f"{entry['min_cc_precision'] * 100:.2f}\t|\t"
                      f"{r[keys[0]] * 100:.2f}\t|\t{r[keys[1]] * 100:.2f}\t"
                      f"{r[keys[2]] * 100:.2f}")

    def print_precision_tables(self, scope_metrics, scope: str) -> None:
        """Per-threshold summary-match tables (reference:
        print_summary_precision_metrics, evaluator.py:815-863)."""
        if self.params.show_counts:
            print(f"\nMatching Params\t|\tSummary Matches (Count - {scope})")
            print("Min. R.\tMin. P.\t|\tE + P\t|\tE. Only\tP. Only\tMiss\t"
                  "BG. Miss\tTotal")
            for entry in scope_metrics:
                p = entry["precision_metrics"]
                e, pa = sum(p["exact_matches"]), sum(p["partial_matches"])
                um, bg = sum(p["unmatched"]), sum(p["bg_unmatched"])
                print(f"{entry['min_cc_recall'] * 100:.2f}\t"
                      f"{entry['min_cc_precision'] * 100:.2f}\t|\t{e + pa}\t|\t"
                      f"{e}\t{pa}\t{um}\t{bg}\t{e + pa + um}")
        for flag, title, keys in (
                (self.params.show_avg_per_frame, "AVG Precision per Frame",
                 ("avg_precision", "avg_only_exact_precision",
                  "avg_only_partial_precision", "avg_prc_bg_not_matched",
                  "avg_no_bg_precision")),
                (self.params.show_globals, "Global Precision",
                 ("precision", "only_exact_precision",
                  "only_partial_precision", "global_bg_unmatched",
                  "no_bg_precision"))):
            if not flag:
                continue
            print(f"\nMatching Params\t|\tSummary Matches ({title} - {scope})")
            print("Min. R.\tMin. P.\t|\tE + P\t|\tE. Only\tP. Only\tBG. %\t"
                  "No BG P.")
            for entry in scope_metrics:
                p = entry["precision_metrics"]
                print(f"{entry['min_cc_recall'] * 100:.2f}\t"
                      f"{entry['min_cc_precision'] * 100:.2f}\t|\t"
                      f"{p[keys[0]] * 100:.2f}\t|\t{p[keys[1]] * 100:.2f}\t"
                      f"{p[keys[2]] * 100:.2f}\t{p[keys[3]] * 100:.2f}\t"
                      f"{p[keys[4]] * 100:.2f}")

    def print_cc_metrics(self, scope_metrics, scope: str) -> None:
        """Compact tab-separated metric tables
        (reference: print_compact_CC_metrics, :865-962)."""
        header = "Min_R\tMin_P"
        rows = [f"{m['min_cc_recall'] * 100:.2f}\t{m['min_cc_precision'] * 100:.2f}"
                for m in scope_metrics]

        if self.params.show_counts:
            header += "\tR_CT_EP\tR_CT_E\tR_CT_P\tR_CT_M\tR_CT_T"
            for k, entry in enumerate(scope_metrics):
                r = entry["recall_metrics"]
                rows[k] += (f"\t{r['exact_matches'] + r['partial_matches']}"
                            f"\t{r['exact_matches']}\t{r['partial_matches']}"
                            f"\t{r['unmatched']}\t{r['count']}")
        if self.params.show_avg_per_frame:
            header += "\tR_AVG_EP\tR_AVG_E\tR_AVG_P"
            for k, entry in enumerate(scope_metrics):
                r = entry["recall_metrics"]
                rows[k] += (f"\t{r['avg_recall'] * 100:.2f}"
                            f"\t{r['avg_only_exact_recall'] * 100:.2f}"
                            f"\t{r['avg_only_partial_recall'] * 100:.2f}")
        if self.params.show_globals:
            header += "\tR_GBL_EP\tR_GBL_E\tR_GBL_P"
            for k, entry in enumerate(scope_metrics):
                r = entry["recall_metrics"]
                rows[k] += (f"\t{r['recall'] * 100:.2f}"
                            f"\t{r['only_exact_recall'] * 100:.2f}"
                            f"\t{r['only_partial_recall'] * 100:.2f}")

        if self.params.show_counts:
            header += "\tP_CT_EP\tP_CT_E\tP_CT_P\tP_CT_M\tP_CT_BG_M\tP_CT_T"
            for k, entry in enumerate(scope_metrics):
                p = entry["precision_metrics"]
                e, pa = sum(p["exact_matches"]), sum(p["partial_matches"])
                um, bg = sum(p["unmatched"]), sum(p["bg_unmatched"])
                rows[k] += f"\t{e + pa}\t{e}\t{pa}\t{um}\t{bg}\t{e + pa + um}"
        if self.params.show_avg_per_frame:
            header += "\tP_AVG_EP\tP_AVG_E\tP_AVG_P\tP_AVG_BGP\tP_AVG_NBG"
            for k, entry in enumerate(scope_metrics):
                p = entry["precision_metrics"]
                rows[k] += (f"\t{p['avg_precision'] * 100:.2f}"
                            f"\t{p['avg_only_exact_precision'] * 100:.2f}"
                            f"\t{p['avg_only_partial_precision'] * 100:.2f}"
                            f"\t{p['avg_prc_bg_not_matched'] * 100:.2f}"
                            f"\t{p['avg_no_bg_precision'] * 100:.2f}")
        if self.params.show_globals:
            header += "\tP_GBL_EP\tP_GBL_E\tP_GBL_P\tP_GBL_BGP\tP_GBL_NBG"
            for k, entry in enumerate(scope_metrics):
                p = entry["precision_metrics"]
                rows[k] += (f"\t{p['precision'] * 100:.2f}"
                            f"\t{p['only_exact_precision'] * 100:.2f}"
                            f"\t{p['only_partial_precision'] * 100:.2f}"
                            f"\t{p['global_bg_unmatched'] * 100:.2f}"
                            f"\t{p['no_bg_precision'] * 100:.2f}")

        print(f"--- {scope} ---")
        print(header)
        for row in rows:
            print(row)
