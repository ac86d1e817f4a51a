"""train.device_idle: share of the traced window with no kernel, copy or
memset on the card (%)."""

from benchmark import readers


def read(run):
    return readers.device_idle(run)
