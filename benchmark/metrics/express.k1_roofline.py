"""express.k1_roofline: K1's least time at the HBM peak over its time in
the trace (%)."""

from benchmark import readers


def read(run):
    return readers.k1_roofline(run, run.config["frame_height"],
                               run.config["frame_width"])
