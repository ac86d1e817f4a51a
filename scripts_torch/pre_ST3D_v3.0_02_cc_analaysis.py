#!/usr/bin/env python
"""Drop-in wrapper under the reference's actual (typo'd) script name
pre_ST3D_v3.0_02_cc_analaysis.py, so existing run books replay verbatim on
the PyTorch port; the corrected-spelling twin pre_ST3D_v3.0_02_cc_analysis.py
also works. Forwards to lecturemath_tpu_torch.cli.cc_analysis."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from lecturemath_tpu_torch.cli.cc_analysis import main

if __name__ == "__main__":
    main()
