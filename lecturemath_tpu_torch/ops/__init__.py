"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and as the reference on the card); the
device ops in plain PyTorch (CLAHE, motion statistics, k-means); and the
host-side CC mask overlap, interval index and classical binarizers."""

from .cc_label import label_components, label_components_batch, compact_labels
from .overlap import candidate_pairs, pairwise_overlap, self_candidate_pairs
from .clahe import clahe, clahe_batch, clahe_host, combine_board_content
from .frame_diff import motion_stats, MotionStats
from .interval_index import IntervalIndex
from . import classical
