"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and as the reference on the card), and the
host-side CC mask overlap that evaluation uses."""

from .cc_label import label_components, label_components_batch, compact_labels
from .overlap import candidate_pairs, pairwise_overlap, self_candidate_pairs
