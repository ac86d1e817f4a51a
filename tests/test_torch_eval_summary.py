"""The port's summary and segment evaluation (eval/summary_eval, evaluator,
annotation, segments_eval and the eval_summaries / eval_segments CLIs)
against the JAX package's on the same synthetic GT tree: a lecture of four
GT keyframes over three segments with polygon video objects (so the object
mask decides which unmatched CCs are background), and a generated summary
that splits the lecture differently, drops 3% of the ink and adds specks.
Every metric must be equal (==) and the CLIs' stdout identical."""

import json
import os

import numpy as np
import pytest

import lecturemath_tpu.cli.eval_segments as jax_eval_segments
import lecturemath_tpu.cli.eval_summaries as jax_eval_summaries
import lecturemath_tpu.eval.segments_eval as jax_se
from lecturemath_tpu.core.config import Config as JaxConfig
from lecturemath_tpu.core.metadata import MetaDataDB as JaxDB
from lecturemath_tpu.eval.annotation import \
    KeyframeAnnotation as JaxKeyframeAnnotation
from lecturemath_tpu.eval.evaluator import Evaluator as JaxEvaluator
from lecturemath_tpu.eval.keyframe_bin import \
    KEYFRAME_BIN_PARAMS as JAX_KEYFRAME_BIN_PARAMS
from lecturemath_tpu.eval.summary_eval import \
    SummaryEvaluator as JaxSummaryEvaluator
import lecturemath_tpu_torch.cli.eval_segments as eval_segments
import lecturemath_tpu_torch.cli.eval_summaries as eval_summaries
import lecturemath_tpu_torch.eval.segments_eval as se
from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.core.metadata import MetaDataDB
from lecturemath_tpu_torch.eval.annotation import KeyframeAnnotation
from lecturemath_tpu_torch.eval.evaluator import Evaluator
from lecturemath_tpu_torch.eval.keyframe_bin import KEYFRAME_BIN_PARAMS
from lecturemath_tpu_torch.eval.summary_eval import SummaryEvaluator

import _torch_eval_tree as tree

PORT = (Config, MetaDataDB, SummaryEvaluator, KeyframeAnnotation, Evaluator)
JAX = (JaxConfig, JaxDB, JaxSummaryEvaluator, JaxKeyframeAnnotation,
       JaxEvaluator)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval"))
    conf = tree.summary_tree(root)
    tree.self_summary_tree(root)
    return root, conf


def _evaluate(package, conf, baseline_prefix=""):
    config_cls, db_cls, evaluator_cls = package[:3]
    config = config_cls.from_file(conf)
    database = db_cls.from_file(config.get_str("VIDEO_DATABASE_PATH"))
    evaluator = evaluator_cls()
    metrics = evaluator.evaluate_lecture(config, database,
                                         database.get_lecture("ev01"),
                                         baseline_prefix)
    return evaluator, metrics


def test_evaluate_lecture_equal(workspace, capsys):
    _, conf = workspace
    ours, our_metrics = _evaluate(PORT, conf)
    theirs, their_metrics = _evaluate(JAX, conf)
    assert our_metrics == their_metrics
    assert ours.ranges_per_lecture == theirs.ranges_per_lecture
    assert ours.keyframe_counts == theirs.keyframe_counts == {"ev01": 4}
    # the specks on the objects count as background: the mask matters
    entry = our_metrics["all"][0]["precision_metrics"]
    assert entry["global_bg_unmatched"] > 0
    assert 0 < entry["precision"] < entry["no_bg_precision"] < 1

    capsys.readouterr()
    ours.print_totals(all_ranges=True)
    our_out = capsys.readouterr().out
    theirs.print_totals(all_ranges=True)
    assert our_out == capsys.readouterr().out
    assert "Averages" in our_out


def test_self_evaluation_is_perfect(workspace):
    """The GT combined per segment, scored as a summary of itself."""
    _, conf = workspace
    ours, our_metrics = _evaluate(PORT, conf, "self_")
    _, their_metrics = _evaluate(JAX, conf, "self_")
    assert our_metrics == their_metrics
    for entry in our_metrics["all"]:
        assert entry["recall_metrics"]["recall"] == 1.0
        assert entry["precision_metrics"]["precision"] == 1.0


def _load_keyframes(package, root):
    """GT keyframes (objects, raw image, binaries) and the summary's, one
    each per GT keyframe, as the keyframe-bin protocol pairs them."""
    keyframe_cls = package[3]
    prefix = os.path.join(root, "output", "annotations", "EVDB_ev01")
    gt = keyframe_cls.load_exported_keyframes(
        os.path.join(prefix, "segments.xml"),
        os.path.join(prefix, "keyframes") + "/")
    keyframe_cls.load_portions(os.path.join(prefix, "portions.xml"), gt,
                               os.path.join(prefix, "portions"))
    summary = keyframe_cls.load_exported_keyframes(
        os.path.join(root, "output", "summaries", "EVDB_ev01",
                     "segments.xml"),
        os.path.join(root, "output", "summaries", "EVDB_ev01",
                     "keyframes") + "/", False, False, True)
    for kf in summary:
        kf.update_binary_cc(False)
    return gt, summary


def test_loaded_keyframes_equal(workspace):
    root, _ = workspace
    for ours, theirs in zip(*(_load_keyframes(p, root)[0]
                              for p in (PORT, JAX))):
        assert (ours.idx, ours.time) == (theirs.idx, theirs.time)
        np.testing.assert_array_equal(ours.raw_image, theirs.raw_image)
        np.testing.assert_array_equal(ours.binary_image, theirs.binary_image)
        np.testing.assert_array_equal(ours.object_mask, theirs.object_mask)
        assert ours.object_mask.any() and not ours.object_mask.all()
        assert [(o.id, o.name, o.shape_type) for o in ours.objects] == \
            [(o.id, o.name, o.shape_type) for o in theirs.objects]


@pytest.mark.parametrize("params", ["default", "keyframe_bin"])
def test_compute_summary_and_pixel_metrics_equal(workspace, params):
    """The keyframe-bin protocol's metrics on GT keyframes with objects
    against the summary's keyframes: fake per-keyframe segments, then
    compute_summary_metrics and compute_pixel_binary_metrics."""
    root, _ = workspace
    results = []
    for package, bin_params in ((PORT, KEYFRAME_BIN_PARAMS),
                                (JAX, JAX_KEYFRAME_BIN_PARAMS)):
        gt, summary = _load_keyframes(package, root)
        evaluator_cls = package[4]
        groups, cc_group, segments = \
            package[3].generate_fake_keyframe_info(gt)
        evaluator = (evaluator_cls(bin_params) if params == "keyframe_bin"
                     else evaluator_cls())
        scope_metrics, scopes = evaluator.compute_summary_metrics(
            segments, gt, groups, cc_group, segments, summary)
        pixel = evaluator_cls.compute_pixel_binary_metrics(gt, summary)
        results.append((scope_metrics, scopes, pixel))
    assert results[0] == results[1]
    pixel = results[0][2]
    assert pixel["board_precision"] != pixel["precision"]


def test_eval_summaries_cli_stdout_equal(workspace, capsys):
    _, conf = workspace
    capsys.readouterr()
    eval_summaries.main(["eval_summaries", conf])
    ours = capsys.readouterr().out
    jax_eval_summaries.main(["eval_summaries", conf])
    assert ours == capsys.readouterr().out
    assert "ev01" in ours and "Finished" in ours


@pytest.mark.parametrize("edited", [False, True])
def test_eval_segments_cli_stdout_equal(workspace, capsys, edited):
    root, conf = workspace
    argv = ["eval_segments", conf, "1"]
    if edited:
        path = os.path.join(root, "edited.json")
        with open(path, "w") as f:
            json.dump({"ev01": {"edited": True}}, f)
        argv.append(path)
    capsys.readouterr()
    eval_segments.main(argv)
    ours = capsys.readouterr().out
    jax_eval_segments.main(argv)
    assert ours == capsys.readouterr().out
    assert "SIoU" in ours and ("(edited)" in ours) == edited


@pytest.mark.parametrize("seed", range(6))
def test_segments_eval_equal(seed):
    """evaluate_lecture_segments on random GT splits and predictions."""
    rng = np.random.default_rng(seed)
    total = int(rng.integers(500, 5000))
    splits = sorted(set(rng.integers(1, total, rng.integers(1, 12)).tolist()))
    cuts = sorted(set(rng.integers(1, total, rng.integers(0, 14)).tolist()))
    bounds = [0] + cuts + [total]
    pred = [(bounds[k], bounds[k + 1]) for k in range(len(bounds) - 1)]
    gt_bounds = [0] + splits + [total]
    assert se.evaluate_lecture_segments(gt_bounds, splits, pred, total) == \
        jax_se.evaluate_lecture_segments(gt_bounds, splits, pred, total)
