"""train.pixels_ms: ms a batch of the training batch's pixel work on the
prefetch thread (the program's ``data.pixels`` spans, once a batch: the
staging, upload and launch of kernel K5 on the card's route, the plain
version on the host's). None where the program records no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "data.pixels", "data.batch")
