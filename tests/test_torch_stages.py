"""The staged pipeline of the port (lecturemath_tpu_torch/pipeline/stages.py
and the stage CLIs) against the JAX package's, on the
tests/test_e2e_pipeline.py scenarios, on the CPU.

Both packages read the same synthetic stage-01 artifact and run stages 02
(host labeling, and device labeling: XLA on the JAX side, the port's plain
version under ``-device cpu``), 03, 04 and 05, each in its own output tree.
The artifacts compare equal field by field and the exported summary trees
byte for byte apart from ``<Filename>``. Then the port's five staged CLIs
run a tiny binarizer with ``-device cpu`` on an RGB lecture, and their
summary equals the port's express summary."""

import os

import cv2
import numpy as np
import pytest
import torch

from lecturemath_tpu.pipeline import stages as jax_stages
from lecturemath_tpu.pipeline.driver import PipelineDriver as JaxDriver
from lecturemath_tpu.pipeline.video import compress_png as jax_compress_png
from lecturemath_tpu.utils.synthetic import (synthetic_lecture,
                                             synthetic_rgb_lecture)
from lecturemath_tpu_torch.cli import (binarize, cc_analysis, cc_grouping,
                                       generate_summary, quickstart,
                                       run_pipeline, vid_segmentation)
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.models.convert import save_checkpoint
from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
from lecturemath_tpu_torch.ops.cc_label import label_components_batch
from lecturemath_tpu_torch.pipeline import stages
from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
from lecturemath_tpu_torch.pipeline.video import compress_png, decompress_png
from lecturemath_tpu_torch.utils.synthetic import threshold_binarizer_variables

torch.set_num_threads(1)

DB_XML = """<AccessMath>
  <DataBase>
    <Name>SynthDB</Name>
    <OutputPaths>
      <Temporal>temporal</Temporal>
      <Images>images</Images>
      <Videos>videos</Videos>
      <Annotations>annotations</Annotations>
      <Summaries>summaries</Summaries>
    </OutputPaths>
    <Datasets>
      <Training><LectureTitle>synth01</LectureTitle></Training>
    </Datasets>
    <Lectures>
      <Lecture>
        <Id>synth01</Id>
        <Title>synth01</Title>
        <Parameters></Parameters>
        <Videos><Main><Video><Path>{video}</Path></Video></Main></Videos>
      </Lecture>
    </Lectures>
  </DataBase>
</AccessMath>
"""

# tests/test_e2e_pipeline.py's settings
SETTINGS = [
    "BINARIZATION_OUTPUT = tempo_binary_",
    "CC_STABILITY_OUTPUT = tempo_stability_",
    "CC_RECONSTRUCTED_OUTPUT = tempo_bin_reconstructed_",
    "CC_CONFLICTS_OUTPUT = tempo_cc_conflicts_",
    "CC_ST3D_OUTPUT = tempo_cc_ST3D_",
    "VIDEO_SEGMENTATION_OUTPUT = tempo_intervals_",
    "SUMMARY_KEYFRAMES_OUTPUT = tempo_segments_",
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
    "SAMPLING_FPS = 1.0",
]

TINY_KEYS = {
    **{f"FCN_BINARIZER_NET_DOWN_CONV_FILTERS_{i}": i + 1 for i in range(1, 6)},
    **{f"FCN_BINARIZER_NET_UPSAMPLE_FILTERS_{i}": i + 1 for i in range(1, 6)},
    **{f"FCN_BINARIZER_NET_UP_CONV_FILTERS_{i}": i + 1 for i in range(1, 6)},
    "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 6,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 4,
    "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 3,
    "FCN_BINARIZER_NET_KERNEL_SIZE": 3,
    "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 3,
}

STAGE03_KEYS = ["CC_RECONSTRUCTED_OUTPUT", "CC_CONFLICTS_OUTPUT",
                "CC_ST3D_OUTPUT"]
LECTURE = "synth01"


def _write_config(root, name, output, extra=()):
    lines = [f"VIDEO_DATABASE_PATH = {root}/db.xml",
             f"VIDEO_FILES_PATH = {root}/videos",
             f"OUTPUT_PATH = {root}/{output}"] + SETTINGS + list(extra)
    path = root / name
    path.write_text("\n".join(lines))
    return str(path)


def _run_stages(driver_cls, stage_module, config, argv=()):
    """Stages 02-05 over the stored stage-01 artifact, as the CLIs run
    them."""
    def make(inputs, outputs):
        return driver_cls.from_config_path(config, list(argv), inputs,
                                           outputs)

    make("BINARIZATION_OUTPUT", "CC_STABILITY_OUTPUT").run(
        stage_module.stage02_cc_analysis)
    make("CC_STABILITY_OUTPUT", STAGE03_KEYS).run(
        stage_module.stage03_cc_grouping)
    keys = stage_module.stage04_input_keys(Config.from_file(config))
    make(keys, "VIDEO_SEGMENTATION_OUTPUT").run(
        stage_module.stage04_segmentation)
    make(["CC_ST3D_OUTPUT", "VIDEO_SEGMENTATION_OUTPUT"],
         "SUMMARY_KEYFRAMES_OUTPUT").run(stage_module.stage05_summary)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """One stage-01 artifact per output tree from tests/test_e2e_pipeline.py's
    synthetic lecture, then stages 02-05 in each tree: the JAX package's
    and the port's (host labeling), and the port's with device labeling on
    the CPU."""
    root = tmp_path_factory.mktemp("staged")
    (root / "db.xml").write_text(DB_XML.format(video="synth01.avi"))
    frames, glyphs, erase_times = synthetic_lecture(
        seed=11, n_frames=40, height=96, width=128, n_boards=2,
        glyphs_per_board=5, jitter=0.0)
    frames = list(frames)
    times = [1000.0 * t for t in range(len(frames))]
    indices = [30 * t for t in range(len(frames))]
    configs = {
        "jax": _write_config(root, "jax.conf", "out_jax"),
        "port": _write_config(root, "port.conf", "out_port"),
        "port_device": _write_config(root, "device.conf", "out_device",
                                     ["CC_ANALYSIS_DEVICE_LABELING = 1",
                                      "CC_ANALYSIS_DEVICE_BATCH = 16"]),
    }
    driver = JaxDriver.from_config_path(configs["jax"], [], None,
                                        "BINARIZATION_OUTPUT")
    driver.save_outputs(driver.database.lectures[0],
                        (times, indices, jax_compress_png(frames)))
    for name in ("port", "port_device"):
        driver = PipelineDriver.from_config_path(configs[name], [], None,
                                                 "BINARIZATION_OUTPUT")
        driver.save_outputs(driver.database.lectures[0],
                            (times, indices, compress_png(frames)))

    _run_stages(JaxDriver, jax_stages, configs["jax"])
    _run_stages(PipelineDriver, stages, configs["port"])
    before = label_components_batch.launches
    _run_stages(PipelineDriver, stages, configs["port_device"],
                ["-device", "cpu"])
    assert label_components_batch.launches == before   # the plain version

    def store(name):
        driver = (JaxDriver if name == "jax" else PipelineDriver)
        return driver.from_config_path(configs[name], [], None, None).store

    return {"root": root, "frames": frames, "glyphs": glyphs,
            "erase_times": erase_times, "configs": configs,
            "stores": {name: store(name) for name in configs}}


def assert_same_tracker(ours, theirs):
    """tests/test_e2e_pipeline.py:207-212, plus the CC ids and times."""
    assert len(ours.unique_ccs) == len(theirs.unique_ccs)
    assert ours.unique_cc_frames == theirs.unique_cc_frames
    assert (ours.width, ours.height, ours.img_idx) == \
        (theirs.width, theirs.height, theirs.img_idx)
    for a, b in zip(ours.unique_ccs, theirs.unique_ccs):
        assert (a.cc_id, a.min_x, a.max_x, a.min_y, a.max_y, a.size,
                a.start_time, a.end_time) == \
            (b.cc_id, b.min_x, b.max_x, b.min_y, b.max_y, b.size,
             b.start_time, b.end_time)
        np.testing.assert_array_equal(a.img, b.img)


def _load(staged, name, key):
    return staged["stores"][name].load(key, LECTURE)


def test_stage01_artifacts_identical(staged):
    ours = _load(staged, "port", "tempo_binary_")
    theirs = _load(staged, "jax", "tempo_binary_")
    assert ours[:2] == theirs[:2]
    assert [buf.tobytes() for buf in ours[2]] == \
        [buf.tobytes() for buf in theirs[2]]
    for frame, decoded in zip(staged["frames"], decompress_png(ours[2])):
        np.testing.assert_array_equal(decoded, frame)


@pytest.mark.parametrize("name", ["port", "port_device"])
def test_stage02_tracker_identical(staged, name):
    times, indices, tracker = _load(staged, name, "tempo_stability_")
    j_times, j_indices, j_tracker = _load(staged, "jax", "tempo_stability_")
    assert (times, indices) == (j_times, j_indices)
    # every glyph is a stable unique CC (tests/test_e2e_pipeline.py:116)
    assert len(tracker.unique_ccs) == len(staged["glyphs"])
    assert_same_tracker(tracker, j_tracker)


def test_stage02_device_labeling_matches_jax_device_labeling(staged):
    """Both packages' CC_ANALYSIS_DEVICE_LABELING branch on one input
    (tests/test_e2e_pipeline.py:196-212)."""
    results = []
    for driver_cls, module, name, argv in (
            (JaxDriver, jax_stages, "jax", []),
            (PipelineDriver, stages, "port", ["-device", "cpu"])):
        driver = driver_cls.from_config_path(staged["configs"][name], argv,
                                             "BINARIZATION_OUTPUT", None)
        driver.config.set("CC_ANALYSIS_DEVICE_LABELING", 1)
        lecture = driver.database.lectures[0]
        results.append(module.stage02_cc_analysis(
            driver, lecture, driver.load_inputs(lecture))[2])
    assert_same_tracker(*results)


@pytest.mark.parametrize("name", ["port", "port_device"])
def test_stage03_artifacts_identical(staged, name):
    times, indices, clean = _load(staged, name, "tempo_bin_reconstructed_")
    j_times, j_indices, j_clean = _load(staged, "jax",
                                        "tempo_bin_reconstructed_")
    assert (times, indices) == (j_times, j_indices)
    assert [buf.tobytes() for buf in clean] == \
        [buf.tobytes() for buf in j_clean]
    assert _load(staged, name, "tempo_cc_conflicts_") == \
        _load(staged, "jax", "tempo_cc_conflicts_")
    st3d = _load(staged, name, "tempo_cc_ST3D_")
    j_st3d = _load(staged, "jax", "tempo_cc_ST3D_")
    for field in ("frame_times", "frame_indices", "height", "width",
                  "group_ages", "group_boundaries"):
        assert getattr(st3d, field) == getattr(j_st3d, field), field
    assert st3d.group_images.keys() == j_st3d.group_images.keys()
    for group, images in st3d.group_images.items():
        assert len(images) == len(j_st3d.group_images[group])
        for mine, other in zip(images, j_st3d.group_images[group]):
            np.testing.assert_array_equal(mine, other)


@pytest.mark.parametrize("name", ["port", "port_device"])
def test_stage04_intervals_identical(staged, name):
    intervals = _load(staged, name, "tempo_intervals_")
    assert intervals == _load(staged, "jax", "tempo_intervals_")
    # the board erase splits the lecture in two (test_e2e_pipeline.py:140)
    assert len(intervals) == 2
    assert abs(intervals[0][1] - staged["erase_times"][0]) <= 3


def _summary_tree(output_root):
    prefix = os.path.join(output_root, "summaries", "SynthDB_synth01")
    with open(os.path.join(prefix, "segments.xml")) as f:
        xml = [line for line in f.read().splitlines()
               if "<Filename>" not in line]
    files = {}
    for name in ("gui_export.xml",):
        with open(os.path.join(prefix, name), "rb") as f:
            files[name] = f.read()
    for name in sorted(os.listdir(os.path.join(prefix, "keyframes"))):
        with open(os.path.join(prefix, "keyframes", name), "rb") as f:
            files[name] = f.read()
    return xml, files


@pytest.mark.parametrize("name", ["port", "port_device"])
def test_stage05_summary_identical(staged, name):
    (indices, times, keyframes), = _load(staged, name, "tempo_segments_")
    (j_indices, j_times, j_keyframes), = _load(staged, "jax",
                                               "tempo_segments_")
    assert (indices, times) == (j_indices, j_times)
    assert len(keyframes) == len(j_keyframes) == 2
    for mine, other in zip(keyframes, j_keyframes):
        np.testing.assert_array_equal(mine, other)
    # each keyframe holds its board (test_e2e_pipeline.py:158-160)
    for keyframe, last in zip(keyframes, (19, 39)):
        np.testing.assert_array_equal(keyframe[:, :, 0],
                                      255 - staged["frames"][last])
    root = staged["root"]
    out = "out_port" if name == "port" else "out_device"
    assert _summary_tree(root / out) == _summary_tree(root / "out_jax")


@pytest.fixture(scope="module")
def rgb_workspace(tmp_path_factory):
    """tests/test_torch_express.py's lecture: RGB frames as a lossless PNG
    image list and a tiny seeded threshold checkpoint."""
    root = tmp_path_factory.mktemp("staged_cli")
    (root / "db.xml").write_text(DB_XML.format(video="synth01"))
    rgb, _, _, erase_times = synthetic_rgb_lecture(
        seed=11, n_frames=40, height=96, width=128, n_boards=2,
        glyphs_per_board=5)
    frame_dir = root / "videos" / "synth01"
    frame_dir.mkdir(parents=True)
    for t, frame in enumerate(rgb):
        cv2.imwrite(str(frame_dir / f"{t:04d}.png"), frame[:, :, ::-1])
    (root / "models").mkdir()
    model = [f"BINARIZATION_FCN_LECTURENET_DIR = {root}/models",
             "BINARIZATION_FCN_LECTURENET_FILENAME = tiny.dat",
             "UPLOAD_FORMAT = rgb"]
    model += [f"{key} = {value}" for key, value in TINY_KEYS.items()]
    configs = {
        "staged": _write_config(root, "staged.conf", "out_staged",
                                model + ["CC_ANALYSIS_DEVICE_LABELING = 1"]),
        "express": _write_config(root, "express.conf", "out_express", model),
    }
    net_config = FCNConfig.from_config(Config.from_file(configs["staged"]))
    save_checkpoint(threshold_binarizer_variables(net_config, seed=1),
                    str(root / "models" / "tiny.dat"))
    return root, configs, erase_times[0]


def test_staged_clis_device_cpu_equal_express(rgb_workspace, capsys):
    root, configs, era_boundary = rgb_workspace
    config = configs["staged"]
    for cli in (binarize, cc_analysis, cc_grouping, vid_segmentation,
                generate_summary):
        cli.main([cli.__name__, config, "-device", "cpu"])
        assert "Finished" in capsys.readouterr().out
    run_pipeline.main(["run_pipeline", configs["express"], "-device", "cpu"])
    assert "synth01: 2 keyframes" in capsys.readouterr().out
    assert _summary_tree(root / "out_staged") == \
        _summary_tree(root / "out_express")
    intervals = PipelineDriver.from_config_path(
        config, [], None, None).store.load("tempo_intervals_", LECTURE)
    assert abs(intervals[0][1] - era_boundary) <= 3


def test_device_entry_points_raise_without_card(rgb_workspace, staged):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, configs, _ = rgb_workspace
    with pytest.raises(RuntimeError, match="CUDA"):
        binarize.main(["binarize", configs["staged"]])
    with pytest.raises(RuntimeError, match="CUDA"):
        cc_analysis.main(["cc_analysis", configs["staged"]])
    # stage 02 itself, with device labeling and without -device cpu
    driver = PipelineDriver.from_config_path(
        staged["configs"]["port_device"], [], "BINARIZATION_OUTPUT", None)
    lecture = driver.database.lectures[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        stages.stage02_cc_analysis(driver, lecture,
                                   driver.load_inputs(lecture))
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["quickstart", str(staged["root"] / "qs_nocard")])


def test_binarize_mesh_is_not_ported(rgb_workspace, capsys):
    """The model axis of a mesh, which used to raise: cli.binarize -mesh
    2x2 and express with TPU_MESH = 1x2 (channel-sharded stage 01 on CPU
    shards) write the meshless artifact and summary, and the JAX package's
    CLIs on the same meshes write the same (tests/test_cli_mesh.py runs
    4x2). The threshold heads read no trunk channel, so bit for bit."""
    from lecturemath_tpu.cli import binarize as jax_binarize
    from lecturemath_tpu.cli import run_pipeline as jax_run_pipeline

    root, configs, _ = rgb_workspace
    text = open(configs["express"]).read()
    paths = {}
    for name, extra in (("single", ""), ("mesh", "\nTPU_MESH = 1x2"),
                        ("jax", "\nTPU_MESH = 1x2")):
        paths[name] = root / f"model_axis_{name}.conf"
        paths[name].write_text(text.replace(
            "out_express", f"out_model_axis_{name}") + extra)
    for name, flag in (("single", []), ("mesh", ["-mesh", "2x2"])):
        binarize.main(["binarize", str(paths[name]), "-device", "cpu"]
                      + flag)
        run_pipeline.main(["run_pipeline", str(paths[name]), "-device",
                           "cpu"])
        assert "synth01: 2 keyframes" in capsys.readouterr().out
    jax_binarize.main(["binarize", str(paths["jax"]), "-mesh", "2x2"])
    jax_run_pipeline.main(["run_pipeline", str(paths["jax"])])
    trees = {name: root / f"out_model_axis_{name}" for name in paths}
    artifact = os.path.join("temporal", f"tempo_binary_{LECTURE}.dat")
    assert (trees["mesh"] / artifact).read_bytes() == \
        (trees["single"] / artifact).read_bytes()
    ours = PipelineDriver.from_config_path(
        str(paths["mesh"]), [], None, None).store.load("tempo_binary_",
                                                       LECTURE)
    theirs = JaxDriver.from_config_path(
        str(paths["jax"]), [], None, None).store.load("tempo_binary_",
                                                      LECTURE)
    assert ours[:2] == theirs[:2] and len(ours[2]) == 40
    for a, b in zip(decompress_png(ours[2]), decompress_png(theirs[2])):
        np.testing.assert_array_equal(a, b)
    assert _summary_tree(trees["mesh"]) == _summary_tree(trees["single"]) \
        == _summary_tree(trees["jax"])


@pytest.mark.parametrize("request_by", ["flag", "config"])
def test_mesh_2x1_cpu_equals_meshless(rgb_workspace, capsys, request_by):
    """Stage 01 and express over a 2x1 mesh of CPU replicas (-mesh 2x1, or
    TPU_MESH = 2x1): the stage-01 artifact and the summary are the
    meshless CLIs' byte for byte."""
    root, configs, _ = rgb_workspace
    text = open(configs["express"]).read()
    paths = {}
    for name in ("single", "mesh"):
        paths[name] = root / f"{name}_{request_by}.conf"
        extra = "\nTPU_MESH = 2x1" if name == "mesh" and \
            request_by == "config" else ""
        paths[name].write_text(text.replace(
            "out_express", f"out_{name}_{request_by}") + extra)
    flag = ["-mesh", "2x1"] if request_by == "flag" else []
    for name in ("single", "mesh"):
        argv = [str(paths[name]), "-device", "cpu"]
        argv += flag if name == "mesh" else []
        binarize.main(["binarize", *argv])
        run_pipeline.main(["run_pipeline", *argv])
        assert "synth01: 2 keyframes" in capsys.readouterr().out
    artifact = os.path.join("temporal", f"tempo_binary_{LECTURE}.dat")
    trees = [root / f"out_{name}_{request_by}" for name in ("single", "mesh")]
    assert (trees[0] / artifact).read_bytes() == \
        (trees[1] / artifact).read_bytes()
    assert _summary_tree(trees[0]) == _summary_tree(trees[1])


def test_quickstart_device_cpu(tmp_path, capsys):
    """tests/test_quickstart.py through the port, with -device cpu passed
    on to run_pipeline."""
    root = str(tmp_path / "qs")
    quickstart.main(["quickstart", root, "-device", "cpu"])
    assert "Done. Summary exported" in capsys.readouterr().out
    kf_dir = os.path.join(root, "output", "summaries", "QuickDB_demo01",
                          "keyframes")
    pngs = sorted(os.listdir(kf_dir))
    assert len(pngs) == 2
    for name in pngs:
        img = cv2.imread(os.path.join(kf_dir, name), 0)
        assert (img == 0).sum() > 0
    assert os.path.exists(os.path.join(root, "models", "demo.dat"))
    # idempotent: a second run reuses the workspace
    quickstart.main(["quickstart", root, "-device", "cpu"])
    assert "Done. Summary exported" in capsys.readouterr().out
