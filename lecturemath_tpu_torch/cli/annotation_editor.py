"""Interactive full-video annotation editor CLI — browser UI for segment
boundaries, per-segment keyframes, and object (speaker) timelines (the
reference's GTContentAnnotator role, reference:
AccessMath/annotation/gt_content_annotator.py:29, launched by
gt_annotator.py:1).

Usage: python -m lecturemath_tpu_torch.cli.annotation_editor <config> -l
<lecture> [-port N]

Opens (or creates) <OUTPUT_PATH>/<db.annotations>/<DB>_<lecture>.xml —
the same file cli.eval_segments and cli.vis_gt_intervals consume — and
serves the editor at http://127.0.0.1:<port>/ with frame scrubbing over
the lecture's video files (or image-list directory).
"""

import os
import sys

from ..core.config import Config, parse_cli_overrides
from ..core.metadata import MetaDataDB
from ..utils.annotation_editor import AnnotationEditorSession, serve


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: python {argv[0]} config -l lecture [-port N]")
        return

    config = Config.from_file(argv[1])
    params = parse_cli_overrides(list(argv[2:]))
    if "l" not in params:
        print("Missing -l <lecture>")
        return
    lecture_name = (params["l"] if not isinstance(params["l"], list)
                    else params["l"][0])

    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    lecture = database.get_lecture(lecture_name)
    if lecture is None:
        print(f"Unknown lecture <{lecture_name}> — available: "
              f"{', '.join(lec.title for lec in database.lectures)}")
        return
    video_root = config.get_str("VIDEO_FILES_PATH", "")
    video_paths = [os.path.join(video_root, video["path"])
                   for video in lecture.main_videos]
    annotation_path = os.path.join(
        config.get_str("OUTPUT_PATH", "output"),
        database.output_annotations,
        f"{database.name}_{lecture.title.lower()}.xml")

    session = AnnotationEditorSession.open(
        annotation_path, database.name, lecture.title, video_paths,
        lecture.forced_resolution)
    server = serve(session, port=int(params.get("port", 8766)))
    host, port = server.server_address
    print(f"Annotation editor for <{lecture.title}> at "
          f"http://{host}:{port}/ ({session.annotation.total_frames} "
          f"frames; Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nStopped (unsaved edits are discarded; use the save button)")


if __name__ == "__main__":
    main()
