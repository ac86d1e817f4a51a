"""train.decode_ms: ms a batch of PNG decoding on the prefetch thread (the
program's ``data.decode`` spans, ``LectureNetDataset._get_pair`` a
sample)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "data.decode", "data.batch")
