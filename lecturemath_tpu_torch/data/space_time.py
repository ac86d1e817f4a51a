"""Spatio-temporal index of grouped CC content ("ST3D").

Semantics match the reference SpaceTimeStruct
(reference: AccessMath/data/space_time_struct.py:4-83): per-group age
breakpoints, per-age-segment group images, and group bounding boxes, plus the
sampled frame times/indices the pipeline worked from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .cc import CC


@dataclass
class SpaceTimeStruct:
    frame_times: List[float]
    frame_indices: List[int]
    height: int
    width: int
    # group_idx -> sorted list of age breakpoints (sample offsets)
    group_ages: Dict[int, List[int]] = field(default_factory=dict)
    # group_idx -> list of uint8 images, one per age segment
    group_images: Dict[int, List[np.ndarray]] = field(default_factory=dict)
    # group_idx -> (min_x, max_x, min_y, max_y)
    group_boundaries: Dict[int, tuple] = field(default_factory=dict)

    def groups_in_frame_range(self, frame_start: int, frame_end: int,
                              group_list: Sequence[int] = None) -> List[int]:
        if group_list is None:
            group_list = list(self.group_ages.keys())
        result = []
        for group_idx in group_list:
            start_rel = self.group_ages[group_idx][0]
            end_rel = self.group_ages[group_idx][-1]
            if (self.frame_indices[start_rel] <= frame_end and
                    frame_start <= self.frame_indices[end_rel]):
                result.append(group_idx)
        return result

    def groups_in_space_region(self, r_min_x, r_max_x, r_min_y, r_max_y,
                               group_list: Sequence[int] = None) -> List[int]:
        if group_list is None:
            group_list = list(self.group_ages.keys())
        result = []
        for group_idx in group_list:
            g_min_x, g_max_x, g_min_y, g_max_y = self.group_boundaries[group_idx]
            if (g_min_x <= r_max_x and r_min_x <= g_max_x and
                    g_min_y <= r_max_y and r_min_y <= g_max_y):
                result.append(group_idx)
        return result

    def get_cc_instances(self, group_list: Sequence[int], frame_idx: int) -> List[CC]:
        instances = []
        for group_idx in group_list:
            ages = self.group_ages[group_idx]
            first_frame = self.frame_indices[ages[0]]
            last_frame = self.frame_indices[ages[-1]]
            if first_frame <= frame_idx <= last_frame:
                interval_idx = 0
                while self.frame_indices[ages[interval_idx + 1]] < frame_idx:
                    interval_idx += 1
            elif frame_idx < first_frame:
                interval_idx = 0
            else:
                interval_idx = len(self.group_images[group_idx]) - 1

            img = self.group_images[group_idx][interval_idx]
            min_x, max_x, min_y, max_y = self.group_boundaries[group_idx]
            size = int(img.sum()) // 255
            instances.append(CC(0, min_x, max_x, min_y, max_y, size, img))
        return instances

    def find_oldest_in_group(self, group_list: Sequence[int]):
        ages = sorted((self.group_ages[g][0], g) for g in group_list)
        rel_idx, group_idx = ages[0]
        return group_idx, self.frame_indices[rel_idx], self.frame_times[rel_idx]
