"""lecturemath_tpu_torch — the lecturemath_tpu framework on PyTorch and CUDA
for one NVIDIA H100.

Same layout as ``lecturemath_tpu`` (core -> data -> native -> ops -> models
-> pipeline -> cli), same configs, databases and artifacts. Stage 01 runs the
FCN-LectureNet forward on the card in bf16 with ``channels_last``; its
full-resolution k x k head convs and its threshold + bit-packing tail are
hand-written CUDA kernels (``csrc/``, built with nvcc at first use). Stages
02-05 run on the host exactly as in the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises.
"""

__version__ = "0.1.0"
