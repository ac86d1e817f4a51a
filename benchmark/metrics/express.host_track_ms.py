"""express.host_track_ms: ms a frame that run_lecture holds the drained
batches (stage 02's CC tracking on the host), timed around each yield of
a stand-in for the binarizer."""

from benchmark import readers


def read(run):
    return readers.span_ms_per_frame(run, "track")
