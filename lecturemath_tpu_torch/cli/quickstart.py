"""Zero-setup end-to-end demo: synthesize a lecture, run all 5 stages.

``python -m lecturemath_tpu_torch.cli.quickstart [workdir] [options]``
builds a complete self-contained workspace (synthetic whiteboard video with
known erase events, metadata DB, config, seeded tiny checkpoint), runs
the full express pipeline (binarize -> CC tracking -> grouping ->
segmentation -> summary), and prints where everything landed plus what to
try next. Further options go to ``run_pipeline``: ``-device cpu`` runs
stage 01 on the CPU, otherwise it runs on the card. OpenCV is needed only
to write the demo video and to decode it. (The reference has no
equivalent; its README walks users through manual dataset/checkpoint
acquisition before anything runs.)

The synthetic lecture has two "boards" separated by a full erase, so a
correct run finds the era boundary and exports one keyframe per board (the
same known-good signal the test suite's e2e pipeline tests assert). The
checkpoint's trunk is a seeded random init and its heads compute a
luminance threshold (utils/synthetic.threshold_binarizer_variables), so the
demo binarizes the board without a trained model.
"""

import os
import sys

DB_XML = """<AccessMath>
  <DataBase>
    <Name>QuickDB</Name>
    <OutputPaths>
      <Temporal>temporal</Temporal>
      <Images>images</Images>
      <Videos>videos</Videos>
      <Annotations>annotations</Annotations>
      <Summaries>summaries</Summaries>
    </OutputPaths>
    <Datasets>
      <Training><LectureTitle>demo01</LectureTitle></Training>
    </Datasets>
    <Lectures>
      <Lecture>
        <Id>demo01</Id>
        <Title>demo01</Title>
        <Parameters></Parameters>
        <Videos><Main><Video><Path>demo01.avi</Path></Video></Main></Videos>
      </Lecture>
    </Lectures>
  </DataBase>
</AccessMath>
"""

# widths 2..6: compiles in seconds anywhere; the pipeline's behavior is
# exercised end-to-end regardless of model quality (see module docstring)
TINY_WIDTHS = {
    "DOWN_CONV_FILTERS": (2, 3, 4, 5, 6),
    "MIDDLE_CONV_FILTERS_MIDDLE": 6,
    "UPSAMPLE_FILTERS": (2, 3, 4, 5, 6),
    "UP_CONV_FILTERS": (2, 3, 4, 5, 6),
    "PIXEL_FEATURES": (3, 2),
}


def build_workspace(root: str, n_samples: int = 40, height: int = 96,
                    width: int = 128) -> str:
    """Create videos/db/config/checkpoint under ``root``; returns the
    config path. Idempotent: an existing workspace is reused."""
    import cv2

    from ..models.convert import save_checkpoint
    from ..models.fcn_lecturenet import FCNConfig
    from ..utils.synthetic import (synthetic_rgb_lecture,
                                   threshold_binarizer_variables)

    conf_path = os.path.join(root, "quickstart.conf")
    for sub in ("videos", "models", "output"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    video_path = os.path.join(root, "videos", "demo01.avi")
    if not os.path.exists(video_path):
        print(f"[1/3] synthesizing lecture video ({n_samples} sampled "
              f"frames, 2 boards) -> {video_path}")
        rgb, _, _, erase_times = synthetic_rgb_lecture(
            seed=11, n_frames=n_samples, height=height, width=width,
            n_boards=2, glyphs_per_board=5)
        writer = cv2.VideoWriter(video_path,
                                 cv2.VideoWriter_fourcc(*"MJPG"),
                                 30.0, (width, height))
        for frame in rgb:
            bgr = frame[:, :, ::-1]
            for _ in range(30):   # 30 video frames per 1 FPS sample
                writer.write(bgr)
        writer.release()
        print(f"      ground-truth erase boundary near sample "
              f"{erase_times[0] if len(erase_times) else '?'}")

    db_path = os.path.join(root, "db.xml")
    if not os.path.exists(db_path):
        with open(db_path, "w") as f:
            f.write(DB_XML)

    model_path = os.path.join(root, "models", "demo.dat")
    if not os.path.exists(model_path):
        print(f"[2/3] seeded tiny checkpoint -> {model_path}")
        config = FCNConfig(
            down_filters=TINY_WIDTHS["DOWN_CONV_FILTERS"],
            mid_filters=TINY_WIDTHS["MIDDLE_CONV_FILTERS_MIDDLE"],
            upsample_filters=TINY_WIDTHS["UPSAMPLE_FILTERS"],
            up_filters=TINY_WIDTHS["UP_CONV_FILTERS"],
            pixel_features=TINY_WIDTHS["PIXEL_FEATURES"],
            kernel_size=3, pixel_kernel_size=3)
        save_checkpoint(threshold_binarizer_variables(config, seed=7),
                        model_path)

    if not os.path.exists(conf_path):
        lines = [
            f"VIDEO_DATABASE_PATH = {db_path}",
            f"VIDEO_FILES_PATH = {os.path.join(root, 'videos')}",
            f"OUTPUT_PATH = {os.path.join(root, 'output')}",
            "BINARIZATION_OUTPUT = tempo_binary_",
            "CC_STABILITY_OUTPUT = tempo_stability_",
            "CC_RECONSTRUCTED_OUTPUT = tempo_bin_reconstructed_",
            "CC_CONFLICTS_OUTPUT = tempo_cc_conflicts_",
            "CC_ST3D_OUTPUT = tempo_cc_ST3D_",
            "VIDEO_SEGMENTATION_OUTPUT = tempo_intervals_",
            "SUMMARY_KEYFRAMES_OUTPUT = tempo_segments_",
            f"BINARIZATION_FCN_LECTURENET_DIR = "
            f"{os.path.join(root, 'models')}",
            "BINARIZATION_FCN_LECTURENET_FILENAME = demo.dat",
            "FCN_BINARIZER_NET_KERNEL_SIZE = 3",
            "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = 3",
            "SAMPLING_FPS = 1.0",
            "CC_STABILITY_MIN_RECALL = 0.85",
            "CC_STABILITY_MIN_PRECISION = 0.85",
            "CC_STABILITY_MAX_GAP = 10",
            "CC_STABILITY_MIN_TIMES = 3",
            "CC_GROUPING_MIN_IMAGE_THRESHOLD = 0.5",
            "CC_GROUPING_TEMPORAL_WINDOW = 5",
            "CC_GROUPING_MIN_RECALL = 0.5",
            "VIDEO_SEGMENTATION_METHOD = 3",
            "VIDEO_SEGMENTATION_DEL_EVENT_MIN_LENGTH = 3",
            "VIDEO_SEGMENTATION_DEL_EVENT_ADD_THRESHOLD = 0.00005",
            "VIDEO_SEGMENTATION_DEL_EVENT_THRESHOLD = 0.0008",
        ]
        for key, value in TINY_WIDTHS.items():
            if isinstance(value, tuple):
                lines += [f"FCN_BINARIZER_NET_{key}_{i + 1} = {v}"
                          for i, v in enumerate(value)]
            else:
                lines.append(f"FCN_BINARIZER_NET_{key} = {value}")
        with open(conf_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return conf_path


def main(argv=None):
    from ..core.config import parse_cli_overrides
    from ..core.device import resolve_device

    argv = sys.argv if argv is None else argv
    args = list(argv[1:])
    workdir = "lecturemath_quickstart"
    if args and not args[0].startswith("-"):
        workdir = args.pop(0)
    # resolve the device before the workspace build: without a card (and
    # without -device cpu) this raises before any work is done
    device = parse_cli_overrides(args).get("device")
    resolve_device(device if isinstance(device, str) else None)
    root = os.path.abspath(workdir)
    conf_path = build_workspace(root)

    print("[3/3] running the full pipeline (express: binarize -> CC "
          "tracking -> grouping -> segmentation -> summary)")
    from .run_pipeline import main as run_pipeline

    run_pipeline(["quickstart", conf_path, *args])

    summary_dir = os.path.join(root, "output", "summaries",
                               "QuickDB_demo01")
    keyframes = []
    kf_dir = os.path.join(summary_dir, "keyframes")
    if os.path.isdir(kf_dir):
        keyframes = sorted(os.listdir(kf_dir))
    print()
    print(f"Done. Summary exported to {summary_dir}")
    print(f"  segments.xml + gui_export.xml + {len(keyframes)} "
          f"keyframe PNG(s): {', '.join(keyframes)}")
    print()
    print("Next steps:")
    print(f"  staged run:  python -m lecturemath_tpu_torch.cli.binarize "
          f"{conf_path}   (then cc_analysis, cc_grouping, "
          f"vid_segmentation, generate_summary)")
    print("  (the tools below are the JAX package's; not ported yet)")
    print(f"  GT editing:  python -m lecturemath_tpu.cli.gt_editor "
          f"{conf_path} -l demo01 -port 8080")
    print(f"  evaluation:  python -m lecturemath_tpu.cli.eval_summaries "
          f"{conf_path}   (needs a GT tree; see README 'Creating "
          f"ground truth')")
    print("  real models: point BINARIZATION_FCN_LECTURENET_DIR/FILENAME "
          "at a reference torch checkpoint (loads directly) and raise "
          "the FCN_BINARIZER_NET_* widths (see MIGRATION.md)")


if __name__ == "__main__":
    main()
