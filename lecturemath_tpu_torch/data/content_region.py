"""Content-region (sketch) container.

Equivalent of the reference's legacy `ContentRegion` class
(reference: AccessMath/data/content_region.py:21-41 — a container the
release itself no longer calls, kept so data pickled against it has a
loading surface): an identified region of board content with creation /
modification / lock / erase bookkeeping, a bounding box and an image
crop.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np


@dataclass
class ContentRegion:
    id: int
    creation_time: float
    last_modified: float
    time_locked: float
    lock_type: int
    overwritten_by: Optional[int]
    time_erased: Optional[float]
    box: Tuple[float, float, float, float]
    image: Optional[np.ndarray]
    name: Optional[str] = None

    # populated by downstream analysis, like the reference's mutable slots
    content: Any = None
    components: List[Any] = field(default_factory=list)

    def save_image(self, path: str) -> None:
        """(reference: content_region.py:39-41 saveImage). Writes a PNG as
        ``cv2.imwrite`` does (a colour image in BGR order), through
        ``utils/png.py``."""
        from ..utils.png import write_image

        write_image(path, self.image)
