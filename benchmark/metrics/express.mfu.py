"""express.mfu: the forward's operations over the frames completed, over
the lectures' wall, over the bf16 peak (%)."""

from benchmark import readers


def read(run):
    return readers.stream_mfu(run)
