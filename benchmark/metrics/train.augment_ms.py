"""train.augment_ms: ms a batch of augmentation on the prefetch thread (the
program's ``data.augment`` spans: flips, crop, colour, noise, luminosity,
a sample)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "data.augment", "data.batch")
