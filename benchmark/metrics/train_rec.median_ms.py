"""train_rec.median_ms: ms a batch of median targets on the prefetch thread
(the program's ``data.median`` spans, ``augment.median_target`` at k = 35,
a sample)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "data.median", "data.batch")
