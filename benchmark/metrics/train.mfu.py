"""train.mfu: the steps' forward and backward operations over the epochs'
wall, over the peak of the precision the convs run in (%)."""

from benchmark import readers


def read(run):
    return readers.train_mfu(run)
