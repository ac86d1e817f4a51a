"""Word/formula-tier GT annotator CLI — browser UI for projection, word
segmentation, unique-word linking, unique-CC linking, and formula tagging
over a GT annotation tree (the reference's GTProjectionAnnotator /
GTWordAnnotator / GTUniqueWordAnnotator / GTUniqueCCAnnotator /
GTFormulaAnnotator roles; reference: AccessMath/annotation/
gt_word_annotator.py:41 and siblings).

Usage: python -m lecturemath_tpu_torch.cli.word_annotator <config> -l <lecture>
[-port N]

Opens <OUTPUT_PATH>/<db.annotations>/<DB>_<lecture>/ and serves the
annotator at http://127.0.0.1:<port>/ with a tool selector (words /
unique CCs / formulas). Saving writes projections.xml,
word_annotations.xml, unique_words.xml, unique_ccs.xml and
formula_ccs.xml in the reference schemas.
"""

import os
import sys

from ..core.config import Config, parse_cli_overrides
from ..core.metadata import MetaDataDB
from ..utils.word_editor import WordTierEditor, serve


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
    lecture = params["l"] if not isinstance(params["l"], list) \
        else params["l"][0]

    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    prefix = os.path.join(config.get_str("OUTPUT_PATH", "output"),
                          database.output_annotations,
                          f"{database.name}_{lecture.lower()}")
    if not os.path.isdir(prefix):
        raise FileNotFoundError(f"no annotation tree at {prefix} — author "
                                f"one first (eval.gt_authoring.export_gt_tree)")

    editor = WordTierEditor(prefix)
    server = serve(editor, port=int(params.get("port", 8767)))
    host, port = server.server_address
    print(f"Word/formula annotator for <{lecture}> at http://{host}:{port}/ "
          f"({len(editor.keyframes)} keyframes; Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nStopped (unsaved edits are discarded; use the save button)")


if __name__ == "__main__":
    main()
