"""train.masks_ms: ms a batch of the training targets on the prefetch
thread (the program's ``data.masks`` spans: text mask, weight map, targets,
a sample)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "data.masks", "data.batch")
