"""train.update_ms: host ms a step in the gradients' reductions over a
mesh, the clip and the optimizer's step (the program's ``train.update``
spans inside ``Trainer.step``'s ``train.step``). None where the program
records no such span."""

from benchmark import program_spans


def read(run):
    return program_spans.per_span_ms(run, "train.update", "train.step")
