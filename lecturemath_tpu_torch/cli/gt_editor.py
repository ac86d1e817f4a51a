"""Interactive GT editor CLI — browser-canvas pixel editing over a GT
annotation tree (the reference's GTPixelBinaryAnnotator role, reference:
AccessMath/annotation/gt_pixel_binary_annotator.py:1).

Usage: python -m lecturemath_tpu_torch.cli.gt_editor <config> -l <lecture>
[-port N]

Opens <OUTPUT_PATH>/<db.annotations>/<DB>_<lecture>/ and serves the editor
at http://127.0.0.1:<port>/ — paint/erase ink, undo, save. Saving rewrites
binary/, portions.xml + portions/, and unique_ccs.xml in place, ready for
cli.eval_summaries.
"""

import os
import sys

from ..core.config import Config, parse_cli_overrides
from ..core.metadata import MetaDataDB
from ..utils.gt_editor import GTEditorSession, serve


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
    lecture = params["l"] if not isinstance(params["l"], list) else params["l"][0]

    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    prefix = os.path.join(config.get_str("OUTPUT_PATH", "output"),
                          database.output_annotations,
                          f"{database.name}_{lecture.lower()}")
    if not os.path.isdir(prefix):
        raise FileNotFoundError(f"no annotation tree at {prefix} — author "
                                f"one first (eval.gt_authoring.export_gt_tree)")

    session = GTEditorSession(prefix)
    server = serve(session, port=int(params.get("port", 8765)))
    host, port = server.server_address
    print(f"GT editor for <{lecture}> at http://{host}:{port}/ "
          f"({len(session.keyframes)} keyframes; Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nStopped (unsaved edits are discarded; use the save button)")


if __name__ == "__main__":
    main()
