"""express.cc_match_ms: ms a frame of stage 02's matching against the live
tracks (the program's ``stage02.match`` spans: ``add_frame_ccs``, with
retirement and the frame log)."""

from benchmark import program_spans


def read(run):
    return program_spans.per_frame_ms(run, "stage02.match")
