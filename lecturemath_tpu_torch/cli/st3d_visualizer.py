"""ST3D structure visualizer CLI — browser scrubber + pixel inspector over
the stage-02/03 artifacts (the reference's ST3D_Visualizer debug GUI,
reference: AccessMath/util/ST3D_visualizer.py:16).

Usage: python -m lecturemath_tpu_torch.cli.st3d_visualizer <config> -l <lecture>
[-port N]

Loads <CC_STABILITY_OUTPUT> and <CC_ST3D_OUTPUT> (plus
<CC_RECONSTRUCTED_OUTPUT> when present) for the lecture and serves the
viewer at http://127.0.0.1:<port>/ — scrub samples, switch
binary/reconstructed/stable views, hover to inspect unique CCs and groups.
"""

import sys

from ..pipeline.driver import PipelineDriver, usage_check
from ..utils.st3d_visualizer import ST3DVisualizerSession, serve


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if not usage_check(argv):
        return

    driver = PipelineDriver.from_config_path(
        argv[1], argv[2:],
        ["CC_STABILITY_OUTPUT", "CC_ST3D_OUTPUT", "CC_RECONSTRUCTED_OUTPUT"],
        None)

    lecture = next(iter(driver.iter_lectures()), None)
    if lecture is None:
        print("No matching lecture (use -l <lecture> / -d <dataset>)")
        return
    stability_prefix, st3d_prefix, reconstructed_prefix = \
        driver.input_prefixes
    if not driver.store.exists(stability_prefix, lecture.id) or \
            not driver.store.exists(st3d_prefix, lecture.id):
        raise FileNotFoundError(
            f"stage-02/03 artifacts for <{lecture.title}> not found under "
            f"{driver.temporal_dir} — run cc_analysis + cc_grouping first")

    session = ST3DVisualizerSession.from_artifacts(
        driver.store, lecture.id, stability_prefix, st3d_prefix,
        reconstructed_prefix, lecture=lecture.title)
    server = serve(session, port=int(driver.params.get("port", 8768)))
    host, port = server.server_address
    print(f"ST3D visualizer for <{lecture.title}> at http://{host}:{port}/ "
          f"({session.n_samples} samples, "
          f"{len(session.tracker.unique_ccs)} unique CCs, "
          f"{len(session.st3d.group_ages)} groups; Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nStopped")


if __name__ == "__main__":
    main()
