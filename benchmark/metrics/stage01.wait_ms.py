"""stage01.wait_ms: ms a frame that the stream's consumer is blocked on the
drain thread's output (the program's ``stage01.wait`` spans in
``_AsyncDrainer``)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_frame_ms(run, "stage01.wait")
