"""express.idle_drain_wait_ms: ms a frame that the card is idle while the
lecture's thread waits in ``stage01.wait`` for the drain thread's next
unpacked batch, from the device trace and the program's spans."""

from benchmark import program_spans


def read(run):
    return program_spans.idle_per_frame_ms(run, "stage01.wait", "lecture")
