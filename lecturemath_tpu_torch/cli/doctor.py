"""Environment + workspace diagnostics.

Usage: python -m lecturemath_tpu_torch.cli.doctor [config] [-device cpu]

Checks the pieces a production run needs — the CUDA card's reachability
(bounded probe: a card or driver may raise AND hang), the hand-written CUDA
kernels K1-K3 (built with nvcc from ``csrc/``), the native C++ kernel
library, ffmpeg, OpenCV video codecs, and, when a config is given, that it
parses, its lecture database loads, video inputs exist, the checkpoint file
is present, and the output tree is writable. Prints one PASS/FAIL/WARN line
per check and exits non-zero on any FAIL. With ``-device cpu`` the card and
its kernels are not needed, and their checks say so. (No reference
equivalent — its failure mode was a stack trace mid-run.)
"""

import os
import sys


class _Report:
    def __init__(self):
        self.failures = 0
        self.lines = []

    def check(self, name, fn, warn_only=False):
        try:
            detail = fn()
            status = "PASS"
        except Exception as err:    # noqa: BLE001 — each check reports
            detail = str(err) or repr(err)
            status = "WARN" if warn_only else "FAIL"
            if not warn_only:
                self.failures += 1
        line = f"[{status}] {name}" + (f": {detail}" if detail else "")
        self.lines.append(line)
        print(line)


def _check_backend(cpu: bool):
    if cpu:
        return "not needed (-device cpu)"
    from ..core.backend_probe import ensure_backend

    timeout_s = float(os.environ.get("LM_DEVICE_PROBE_TIMEOUT_S", "120"))
    if timeout_s <= 0:
        # the probe is opted out — do NOT touch CUDA unbounded here; the
        # diagnostic must never hang on the very failure mode it exists to
        # name
        return "probe skipped (LM_DEVICE_PROBE_TIMEOUT_S=0)"
    ensure_backend(timeout_s)   # same default as the device CLIs
    import torch

    # warm after the probe: bounded
    return (f"{torch.cuda.device_count()}x "
            f"{torch.cuda.get_device_name(0)}")


def _check_kernels(cpu: bool):
    if cpu:
        return "not needed (-device cpu)"
    from ..ops import cuda_build

    cuda_build.nvcc()   # raises with the reason when the toolkit is missing
    cuda_build.build()
    return ", ".join(os.path.basename(cuda_build.library_path(name))
                     for name in cuda_build.SOURCES)


def _check_native():
    from .. import native

    if not native.available():
        raise RuntimeError("native library failed to build/load "
                           "(host CC paths will fall back to numpy)")
    return os.path.basename(native.build())


def _check_ffmpeg():
    import shutil

    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError("ffmpeg not on PATH (video export falls back "
                           "to OpenCV, no audio mux)")
    return path


def _check_cv2_codec():
    import tempfile

    import cv2
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"),
                                 30.0, (32, 32))
        writer.write(np.zeros((32, 32, 3), np.uint8))
        writer.release()
        capture = cv2.VideoCapture(path)
        ok, _ = capture.read()
        capture.release()
        if not ok:
            raise RuntimeError("OpenCV cannot round-trip MJPG video")
    return f"opencv {cv2.__version__}"


def main(argv=None):
    from ..core.config import parse_cli_overrides

    argv = sys.argv if argv is None else argv
    args = list(argv[1:])
    cut = next((i for i, a in enumerate(args) if a.startswith("-")),
               len(args))
    positional, params = args[:cut], parse_cli_overrides(args[cut:])
    device = params.get("device")
    if device is not None and device not in ("cpu", "cuda"):
        raise ValueError("-device takes cpu or cuda")
    cpu = device == "cpu"
    report = _Report()

    report.check("device backend", lambda: _check_backend(cpu))
    report.check("CUDA kernels", lambda: _check_kernels(cpu))
    report.check("native C++ kernels", _check_native)
    report.check("ffmpeg", _check_ffmpeg, warn_only=True)
    report.check("opencv video codec", _check_cv2_codec)

    if positional:
        from ..core.config import Config
        from ..core.metadata import MetaDataDB

        config_path = positional[0]
        state = {}

        def _config():
            state["config"] = Config.from_file(config_path)
            return f"{config_path}"

        def _database():
            config = state["config"]
            database = MetaDataDB.from_file(
                config.get_str("VIDEO_DATABASE_PATH"))
            state["database"] = database
            return (f"{database.name}: {len(database.lectures)} lectures, "
                    f"{len(database.datasets)} datasets")

        def _videos():
            config, database = state["config"], state["database"]
            video_root = config.get_str("VIDEO_FILES_PATH", "")
            missing = []
            for lecture in database.lectures:
                for video in lecture.main_videos:
                    path = os.path.join(video_root, video["path"])
                    if not os.path.exists(path):
                        missing.append(lecture.title)
                        break
            if missing:
                raise RuntimeError(
                    f"{len(missing)} lecture(s) with missing video input: "
                    f"{', '.join(missing[:5])}"
                    + ("..." if len(missing) > 5 else ""))
            return f"{len(database.lectures)} lecture inputs found"

        def _checkpoint():
            config = state["config"]
            path = os.path.join(
                config.get_str("BINARIZATION_FCN_LECTURENET_DIR", "models"),
                config.get_str("BINARIZATION_FCN_LECTURENET_FILENAME",
                               "model.msgpack"))
            if not os.path.exists(path):
                raise RuntimeError(f"checkpoint not found: {path}")
            size = (sum(os.path.getsize(os.path.join(root, f))
                        for root, _, files in os.walk(path) for f in files)
                    if os.path.isdir(path) else os.path.getsize(path))
            return f"{path} ({size / 1e6:.1f} MB)"

        def _output():
            config = state["config"]
            out_root = config.get_str("OUTPUT_PATH", "output")
            os.makedirs(out_root, exist_ok=True)
            probe = os.path.join(out_root, ".doctor_probe")
            with open(probe, "w") as fh:
                fh.write("ok")
            os.remove(probe)
            return f"{out_root} writable"

        report.check("config parses", _config)
        if "config" in state:
            report.check("lecture database", _database)
            if "database" in state:
                report.check("video inputs", _videos, warn_only=True)
            # these need only the parsed config — report them even when
            # the database check failed (one-shot diagnostics)
            report.check("model checkpoint", _checkpoint)
            report.check("output tree", _output)
    else:
        print("(pass a config path to also check the workspace: db, "
              "videos, checkpoint, output tree)")

    print(f"\n{'ALL CHECKS PASSED' if report.failures == 0 else str(report.failures) + ' CHECK(S) FAILED'}")
    return 0 if report.failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
