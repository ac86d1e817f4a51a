"""train.wait_ms: ms a step that the trainer is blocked on the prefetch
thread's next batch (the program's ``train.wait`` spans in
``PrefetchIterator.__next__``)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "train.wait", "train.step")
