"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and as the reference on the card)."""

from .cc_label import label_components, label_components_batch, compact_labels
