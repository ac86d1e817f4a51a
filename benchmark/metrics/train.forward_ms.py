"""train.forward_ms: host ms a step in the forward and the phase's losses
(the program's ``train.forward`` spans inside ``Trainer.step``'s
``train.step``). None where the program records no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "train.forward", "train.step")
