"""express.stage02_cpu_share: the tracking thread's CPU time over the wall
of the program's ``stage02.track`` spans (%): below 100, the thread waited
off the CPU (for the interpreter lock or a core) while it tracked."""

from benchmark import program_spans


def read(run):
    return program_spans.cpu_share(run, "stage02.track")
