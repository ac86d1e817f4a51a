"""The express pipeline of the port (lecturemath_tpu_torch.pipeline.express
run_lecture and cli.run_pipeline) against the JAX package's run_lecture: the
tests/test_e2e_pipeline.py workspace, a real TINY binarizer on each side
loaded from one torch checkpoint, fp32 on the CPU. Summaries, keyframes and
the exported summary tree must be identical."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.pipeline.driver import PipelineDriver as JaxDriver
from lecturemath_tpu.pipeline.express import run_lecture as jax_run_lecture
from lecturemath_tpu.utils.synthetic import synthetic_rgb_lecture
from lecturemath_tpu_torch.cli import run_pipeline
from lecturemath_tpu_torch.models.convert import save_checkpoint
from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
from lecturemath_tpu_torch.pipeline.express import run_lecture
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
        <Videos><Main><Video><Path>synth01</Path></Video></Main></Videos>
      </Lecture>
    </Lectures>
  </DataBase>
</AccessMath>
"""

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


def _write_config(root, name, output):
    lines = [
        f"VIDEO_DATABASE_PATH = {root}/db.xml",
        f"VIDEO_FILES_PATH = {root}/videos",
        f"OUTPUT_PATH = {root}/{output}",
        f"BINARIZATION_FCN_LECTURENET_DIR = {root}/models",
        "BINARIZATION_FCN_LECTURENET_FILENAME = tiny.dat",
        "UPLOAD_FORMAT = rgb",
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
    ] + [f"{key} = {value}" for key, value in TINY_KEYS.items()]
    path = root / name
    path.write_text("\n".join(lines))
    return str(path)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Frames as a lossless PNG image list (an ImageListSource lecture), a
    torch checkpoint both packages load, and one config per output tree."""
    root = tmp_path_factory.mktemp("express")
    (root / "db.xml").write_text(DB_XML)
    rgb, _, _, erase_times = synthetic_rgb_lecture(
        seed=11, n_frames=40, height=96, width=128, n_boards=2,
        glyphs_per_board=5)
    frame_dir = root / "videos" / "synth01"
    frame_dir.mkdir(parents=True)
    for t, frame in enumerate(rgb):
        cv2.imwrite(str(frame_dir / f"{t:04d}.png"), frame[:, :, ::-1])
    (root / "models").mkdir()
    config = _write_config(root, "jax.conf", "out_jax")
    save_checkpoint(threshold_binarizer_variables(
        FCNConfig.from_config(PipelineDriver.from_config_path(
            config, [], None, None).config), seed=1),
        str(root / "models" / "tiny.dat"))
    return root, erase_times[0]


@pytest.fixture(scope="module")
def jax_result(workspace):
    root, _ = workspace
    driver = JaxDriver.from_config_path(str(root / "jax.conf"), [], None,
                                        None)
    binarizer = JaxBinarizer.from_config(driver.config, dtype=jnp.float32)
    return jax_run_lecture(driver, driver.database.lectures[0], binarizer)


def _summary_tree(root, output):
    prefix = os.path.join(root, output, "summaries", "SynthDB_synth01")
    with open(os.path.join(prefix, "segments.xml")) as f:
        xml = [line for line in f.read().splitlines()
               if "<Filename>" not in line]
    pngs = {}
    for name in sorted(os.listdir(os.path.join(prefix, "keyframes"))):
        with open(os.path.join(prefix, "keyframes", name), "rb") as f:
            pngs[name] = f.read()
    return xml, pngs


def _assert_same_summary(ours, theirs):
    indices, times, keyframes = ours
    j_indices, j_times, j_keyframes = theirs
    assert indices == j_indices
    assert times == j_times
    assert len(keyframes) == len(j_keyframes)
    for mine, other in zip(keyframes, j_keyframes):
        np.testing.assert_array_equal(mine, other)


def test_run_lecture_matches_jax(workspace, jax_result):
    root, era_boundary = workspace
    config = _write_config(root, "port.conf", "out_port")
    driver = PipelineDriver.from_config_path(config, [], None, None)
    binarizer = Binarizer.from_config(driver.config, dtype=torch.float32,
                                      device="cpu")
    result = run_lecture(driver, driver.database.lectures[0], binarizer)
    _assert_same_summary(result, jax_result)

    # the synthetic lecture's two boards: two inked keyframes
    indices, _, keyframes = result
    assert len(keyframes) == 2
    assert all((keyframe == 0).any() for keyframe in keyframes)
    assert _summary_tree(root, "out_port") == _summary_tree(root, "out_jax")


def test_cli_device_cpu_matches_jax(workspace, jax_result, capsys):
    """cli.run_pipeline with the -device cpu override."""
    root, _ = workspace
    config = _write_config(root, "cli.conf", "out_cli")
    run_pipeline.main(["run_pipeline", config, "-device", "cpu"])
    assert "synth01: 2 keyframes" in capsys.readouterr().out
    assert _summary_tree(root, "out_cli") == _summary_tree(root, "out_jax")


def test_default_device_without_cuda_raises(workspace):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root, _ = workspace
    driver = PipelineDriver.from_config_path(str(root / "jax.conf"), [],
                                             None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_lecture(driver, driver.database.lectures[0], export=False)
