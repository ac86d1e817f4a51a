#!/usr/bin/env python
"""Drop-in wrapper for the reference script of the same name on the
PyTorch port; forwards to lecturemath_tpu_torch.cli.train_binarizer."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lecturemath_tpu_torch.cli.train_binarizer import main

if __name__ == "__main__":
    main()
