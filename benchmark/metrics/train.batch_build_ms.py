"""train.batch_build_ms: ms the prefetch thread spends building a batch in
LectureNetDataset.batches (decode, augment, stack)."""

from benchmark import readers


def read(run):
    return readers.span_ms_mean(run, "batch_build")
