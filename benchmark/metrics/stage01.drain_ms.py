"""stage01.drain_ms: ms a frame that the stage-01 stream's drain spends
waiting for and unpacking each batch's bits (Binarizer.stream_stats
drain_s, on the drain thread)."""

from benchmark import readers


def read(run):
    return readers.counter_ms_per_frame(run, "drain_s")
