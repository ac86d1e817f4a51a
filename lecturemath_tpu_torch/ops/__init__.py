"""Hand-written CUDA kernels of the stage-01 path, each beside its plain
PyTorch version (used for CPU tensors and as the reference on the card)."""
