"""express.cc_extract_ms: ms a frame of stage 02's CC extraction (the
program's ``stage02.extract`` spans: ``extract_ccs`` in
``CCTracker.add_frame``, the native labeling and the CC objects)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_frame_ms(run, "stage02.extract")
