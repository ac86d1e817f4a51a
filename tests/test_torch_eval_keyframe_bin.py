"""The port's binarizer-quality protocol (eval/keyframe_bin) and the
text-detector pretrain evaluation CLI against the JAX package's, fp32 on
the CPU at TINY widths: both load the same ``.msgpack`` (threshold head
weights written by the JAX package; the port reads it through
models/convert.py) and the same GT tree (5 RGB keyframes in two resolution
buckets, polygon objects). The keyframe binaries, the saved binary PNGs'
bytes, every metric and the CLIs' stdout (apart from the timing line) must
be equal."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lecturemath_tpu.cli.eval_text_detector as jax_eval_text_detector
import lecturemath_tpu.eval.keyframe_bin as jax_keyframe_bin
from lecturemath_tpu.core.config import Config as JaxConfig
from lecturemath_tpu.core.metadata import MetaDataDB as JaxDB
from lecturemath_tpu.eval.summary_eval import \
    load_dataset_keyframes as jax_load_dataset_keyframes
from lecturemath_tpu.models.fcn_lecturenet import FCNConfig as JaxFCNConfig
from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.pipeline.binarize import save_checkpoint_variables
from lecturemath_tpu.utils.synthetic import (synthetic_rgb_lecture,
                                             threshold_binarizer_variables)
import lecturemath_tpu_torch.cli.eval_text_detector as eval_text_detector
import lecturemath_tpu_torch.eval.keyframe_bin as keyframe_bin
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.core.metadata import MetaDataDB
from lecturemath_tpu_torch.eval.annotation import cc_str_id
from lecturemath_tpu_torch.eval.summary_eval import load_dataset_keyframes
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.utils.png import ImageFormatError

import _torch_eval_tree as tree

torch.set_num_threads(1)

N_PAIRS = 4


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The GT tree, the .msgpack checkpoint and text-detector image/mask
    pairs (PNG) at 48x64."""
    root = str(tmp_path_factory.mktemp("kb"))
    conf = tree.keyframe_bin_tree(root)
    with open(conf, "a") as f:
        f.write(f"FCN_BINARIZER_PRETRAIN_EVAL_IMAGES_DIR = {root}/td/images\n"
                f"FCN_BINARIZER_PRETRAIN_EVAL_MASKS_DIR = {root}/td/masks\n")
    config = JaxConfig.from_file(conf)
    model_path = os.path.join(root, "threshold.msgpack")
    save_checkpoint_variables(threshold_binarizer_variables(
        JaxFCNConfig.from_config(config)), model_path)

    rgb, binary, _, _ = synthetic_rgb_lecture(seed=7, n_frames=N_PAIRS,
                                              height=48, width=64,
                                              glyphs_per_board=4,
                                              glyph_size=(10, 12))
    for k in range(N_PAIRS):
        tree.write_png(os.path.join(root, "td", "images", f"p{k}.png"),
                       rgb[k][:, :, ::-1])
        # the GT text mask: the ink, shifted by a pixel on every other pair
        tree.write_png(os.path.join(root, "td", "masks", f"p{k}.png"),
                       np.roll(binary[k], k % 2, axis=1))
    return root, conf, model_path


@pytest.fixture
def fp32(monkeypatch):
    """Both packages' binarizers in fp32, wherever the code under test
    builds them."""
    port, jax_ = Binarizer.from_config, JaxBinarizer.from_config
    monkeypatch.setattr(Binarizer, "from_config", lambda config, **kw: port(
        config, **dict(kw, dtype=torch.float32)))
    monkeypatch.setattr(JaxBinarizer, "from_config", lambda config, **kw:
                        jax_(config, **dict(kw, dtype=jnp.float32)))


def test_loaded_dataset_keyframes_equal(workspace):
    _, conf, _ = workspace
    results = []
    for config_cls, db_cls, load in ((Config, MetaDataDB,
                                      load_dataset_keyframes),
                                     (JaxConfig, JaxDB,
                                      jax_load_dataset_keyframes)):
        config = config_cls.from_file(conf)
        database = db_cls.from_file(config.get_str("VIDEO_DATABASE_PATH"))
        results.append(load(config.get_str("OUTPUT_PATH"), database,
                            "training"))
    for ours, theirs in zip(results[0][0] + results[0][1],
                            results[1][0] + results[1][1]):
        assert (ours.idx, ours.time, ours.lecture) == \
            (theirs.idx, theirs.time, theirs.lecture)
        np.testing.assert_array_equal(ours.raw_image, theirs.raw_image)
        np.testing.assert_array_equal(ours.binary_image, theirs.binary_image)
        np.testing.assert_array_equal(ours.object_mask, theirs.object_mask)
        assert ([cc_str_id(cc) for cc in ours.binary_cc or []]
                == [cc_str_id(cc) for cc in theirs.binary_cc or []])
    assert len(results[0][0]) == 5


def _evaluate(workspace, module, save_dir, **kwargs):
    _, conf, model_path = workspace
    config_cls = Config if module is keyframe_bin else JaxConfig
    config = config_cls.from_file(conf)
    config.set("FCN_BINARIZER_SAVE_BINARY_PATH", save_dir)
    return module.evaluate_keyframe_binarization(
        config, model_path, "training", save_binaries=True, **kwargs)


def test_keyframe_binarization_equal(workspace, fp32, tmp_path):
    """Metrics, and the saved 3-channel binaries byte for byte."""
    ours = _evaluate(workspace, keyframe_bin, str(tmp_path / "port"),
                     device="cpu")
    theirs = _evaluate(workspace, jax_keyframe_bin, str(tmp_path / "jax"))
    assert ours == theirs
    scope_metrics, scopes, pixel = ours
    assert "all" in scopes
    assert 0 < pixel["recall"] <= 1 and pixel["board_precision"] > 0
    for idx in range(100, 600, 100):
        paths = [tmp_path / side / "FCN" / "kb01" / "binary" / f"{idx}.png"
                 for side in ("port", "jax")]
        assert paths[0].read_bytes() == paths[1].read_bytes()


def test_binarize_keyframes_equal(workspace):
    """binarize_keyframes on the loaded keyframes, both packages, each in
    batches of 2 (the last chunk of each bucket short)."""
    root, conf, model_path = workspace
    config = Config.from_file(conf)
    database = MetaDataDB.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    _, ours = load_dataset_keyframes(config.get_str("OUTPUT_PATH"), database)
    jax_config = JaxConfig.from_file(conf)
    _, theirs = jax_load_dataset_keyframes(
        jax_config.get_str("OUTPUT_PATH"),
        JaxDB.from_file(jax_config.get_str("VIDEO_DATABASE_PATH")))
    for cfg in (config, jax_config):
        cfg.set("BINARIZATION_FCN_LECTURENET_DIR", os.path.dirname(model_path))
        cfg.set("BINARIZATION_FCN_LECTURENET_FILENAME",
                os.path.basename(model_path))
    keyframe_bin.binarize_keyframes(
        Binarizer.from_config(config, dtype=torch.float32, device="cpu",
                              batch_size=2), ours)
    jax_keyframe_bin.binarize_keyframes(
        JaxBinarizer.from_config(jax_config, dtype=jnp.float32,
                                 batch_size=2), theirs)
    for a, b in zip(ours, theirs):
        assert a.binary_image.shape == b.binary_image.shape
        np.testing.assert_array_equal(a.binary_image, b.binary_image)
        assert (a.binary_image == 0).any() and (a.binary_image == 255).any()
        assert len(a.binary_cc) == len(b.binary_cc)


def _stdout_without_timing(text):
    return [line for line in text.splitlines()
            if not line.startswith("Total time")]


def test_keyframe_bin_main_stdout_equal(workspace, fp32, capsys):
    _, conf, model_path = workspace
    capsys.readouterr()
    keyframe_bin.main(["keyframe_bin", conf, model_path, "0", "-device",
                       "cpu"])
    ours = capsys.readouterr().out
    jax_keyframe_bin.main(["keyframe_bin", conf, model_path, "0"])
    assert _stdout_without_timing(ours) == \
        _stdout_without_timing(capsys.readouterr().out)
    assert "Pixel level metrics" in ours and "Total time" in ours


def test_eval_text_detector_cli_stdout_equal(workspace, fp32, capsys):
    _, conf, model_path = workspace
    capsys.readouterr()
    eval_text_detector.main(["eval_text_detector", conf, model_path,
                             "-device", "cpu"])
    ours = capsys.readouterr().out
    jax_eval_text_detector.main(["eval_text_detector", conf, model_path])
    assert ours == capsys.readouterr().out
    assert ours.count("Processing:") == N_PAIRS and "Pixel" in ours


@pytest.mark.parametrize("main", [keyframe_bin.main, eval_text_detector.main])
def test_eval_clis_usage_and_no_card(workspace, capsys, main):
    """Too few arguments print the usage; without -device cpu the CLIs
    run on the card, and without one they raise instead of falling back to
    the CPU."""
    _, conf, model_path = workspace
    main(["cli"])
    assert "Usage" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="-device cpu"):
            main(["cli", conf, model_path, "0"])


def test_jpeg_needs_opencv(tmp_path):
    """A JPEG GT image decodes through OpenCV where it is installed, and
    raises naming OpenCV where it is not."""
    import cv2

    from lecturemath_tpu_torch.utils.png import read_image

    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, np.full((20, 30, 3), 200, np.uint8))
    np.testing.assert_array_equal(read_image(path), cv2.imread(path))
    np.testing.assert_array_equal(read_image(path, grayscale=True),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        with pytest.raises(ImageFormatError, match="JPEG.*OpenCV"):
            read_image(path)
    finally:
        sys.modules["cv2"] = saved


def test_read_image_equals_cv2_imread(workspace):
    """read_image on the tree's PNGs (colour and 3-channel binary) and on
    the gray masks, as cv2.imread reads them."""
    import cv2

    from lecturemath_tpu_torch.utils.png import read_image

    root, _, _ = workspace
    prefix = os.path.join(root, "output", "annotations", "EVDB_kb01")
    paths = [os.path.join(prefix, sub, "100.png")
             for sub in ("keyframes", "binary")]
    paths += [os.path.join(root, "td", "masks", "p0.png")]
    for path in paths:
        np.testing.assert_array_equal(read_image(path), cv2.imread(path))
        np.testing.assert_array_equal(read_image(path, grayscale=True),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
