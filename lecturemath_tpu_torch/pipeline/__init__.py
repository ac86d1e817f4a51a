from .cc_tracking import CCTracker
from .segmentation import (segments_from_sums, segments_from_conflicts,
                           segments_from_deletion_events, find_signal_peaks)
from .keyframes import extract_keyframes, export_summary
