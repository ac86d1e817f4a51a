"""express.idle_source_ms: ms a frame that the card is idle while the
lecture's thread is in ``stage01.source`` (taking the next batch of frames
on the host), from the device trace and the program's spans."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_per_frame_ms(run, "stage01.source", "lecture")
