"""express.stage01_dispatch_ms: ms a frame of the stage-01 stream's upload
and dispatch (Binarizer.stream_stats dispatch_s)."""

from benchmark import readers


def read(run):
    return readers.counter_ms_per_frame(run, "dispatch_s")
