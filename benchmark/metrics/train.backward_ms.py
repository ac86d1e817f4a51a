"""train.backward_ms: host ms a step in the backward (the program's
``train.backward`` spans inside ``Trainer.step``'s ``train.step``). None
where the program records no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "train.backward", "train.step")
