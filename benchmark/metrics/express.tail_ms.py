"""express.tail_ms: ms a lecture from the end of the stage-01 stream to
run_lecture's return (stages 03-05 on the host)."""

from benchmark import readers


def read(run):
    return readers.span_ms_mean(run, "tail")
