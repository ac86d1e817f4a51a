"""express.k2_roofline: K2's least time at the bf16 peak over its time in
the trace (%)."""

from benchmark import readers


def read(run):
    return readers.k2_roofline(run, run.config["frame_height"],
                               run.config["frame_width"])
