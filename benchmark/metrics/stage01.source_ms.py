"""stage01.source_ms: ms a frame that the stage-01 stream spends taking
batches from its source (Binarizer.stream_stats source_s)."""

from benchmark import readers


def read(run):
    return readers.counter_ms_per_frame(run, "source_s")
