"""The port's WorkerBinarizer (pipeline/device_worker.py): the recycled
device-worker child must be bit-identical to the in-process Binarizer at
any recycle granularity, and the express pipeline must produce the same
summary through it — and the JAX package's on the same weights carried
across by models/convert.py. Counterparts of tests/test_device_worker.py,
on the CPU (``device="cpu"``) at TINY widths.

Every wait has its own timeout (thread joins, the worker's bounded gets),
so a hang fails its test instead of stalling the suite."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from lecturemath_tpu_torch.core.config import Config
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.device_worker import (
    WorkerBinarizer, default_compile_cache)
from lecturemath_tpu_torch.pipeline.video import ArraySource
from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

WIDTHS = {f"FCN_BINARIZER_NET_{key}_{i}": v
          for key, values in (("DOWN_CONV_FILTERS", (2, 3, 4, 5, 6)),
                              ("UPSAMPLE_FILTERS", (2, 3, 4, 5, 6)),
                              ("UP_CONV_FILTERS", (2, 3, 4, 5, 6)))
          for i, v in enumerate(values, 1)}
# no checkpoint: the child and the reference draw the same seeded init
CONFIG = {**WIDTHS,
          "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE": 6,
          "FCN_BINARIZER_NET_PIXEL_FEATURES_1": 4,
          "FCN_BINARIZER_NET_PIXEL_FEATURES_2": 3,
          "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE": 3,
          "BINARIZATION_FCN_LECTURENET_DIR": "no_such_models_dir",
          "SAMPLING_FPS": 1.0}
BATCH = {"batch_size": 4}
JOIN_S = 180


@pytest.fixture(scope="module")
def frames():
    rgb, _, _, _ = synthetic_rgb_lecture(seed=1, n_frames=12, height=96,
                                         width=128, n_boards=1,
                                         glyphs_per_board=4)
    return rgb


@pytest.fixture(scope="module")
def config():
    return Config(dict(CONFIG))


@pytest.fixture(scope="module")
def reference(config, frames):
    """The in-process Binarizer's (times, indices, frames) at batch 4."""
    binarizer = Binarizer.from_config(config, allow_random=True,
                                      device="cpu", **BATCH)
    return binarizer.process_source(ArraySource(frames))


def worker(config, **kwargs):
    kwargs.setdefault("binarizer_kwargs", BATCH)
    return WorkerBinarizer(config, allow_random=True, device="cpu", **kwargs)


def assert_same(got, want):
    times, indices, frames = got
    assert times == want[0]
    assert indices == want[1]
    assert len(frames) == len(want[2])
    for mine, other in zip(frames, want[2]):
        np.testing.assert_array_equal(mine, other)


def test_worker_matches_inprocess_with_recycling(config, frames, reference):
    """A 1 MB budget: every drained batch's RSS report exceeds it, so the
    child recycles at the next chunk boundary (maximum churn). The child's
    random init is seeded as the in-process one, so the weights are the
    same without a checkpoint."""
    binarizer = worker(config, recycle_mb=1.0, chunk_frames=4)
    try:
        got = binarizer.process_source(ArraySource(frames))
    finally:
        binarizer.close()
    assert binarizer.recycles >= 1
    assert_same(got, reference)
    # the CPU path launches no kernel; each stream reports its counts
    assert binarizer.launches == {"threshold_pack": 0, "conv_same_nhwc": 0}
    assert len(binarizer.recycle_stalls_s) == binarizer.recycles
    first = binarizer.children[0]
    assert first["start_to_ready_s"] > 0 and not first["spare"]
    assert first["peak_rss_mb"] >= first["ready_rss_mb"] > 0


def test_worker_no_recycle_and_reuse(config, frames, reference):
    """recycle_mb=0 keeps one child for several streams (the multi-lecture
    CLI pattern) with identical results each time."""
    binarizer = worker(config, chunk_frames=3)
    try:
        first = binarizer.process_source(ArraySource(frames[:6]))
        child = binarizer._child
        second = binarizer.process_source(ArraySource(frames[:6]))
        assert binarizer._child is child
    finally:
        binarizer.close()
    assert binarizer.recycles == 0
    want = tuple(part[:6] for part in reference)
    assert_same(first, want)
    assert_same(second, want)
    assert not binarizer._child


def test_abort_mid_stream_closes_promptly(config, frames):
    """Abandon stream_source mid-stream, then close(): close must return
    promptly (bounded) though the child still owes results."""
    binarizer = worker(config, chunk_frames=2,
                       binarizer_kwargs={"batch_size": 2})
    gen = binarizer.stream_source(ArraySource(frames))
    next(gen)
    gen.close()
    start = time.monotonic()
    binarizer.close()
    assert time.monotonic() - start < 45
    assert binarizer._child is None


def test_silently_killed_child_raises_not_hangs(config, frames):
    """A child killed without an error message (SIGKILL) surfaces as a
    RuntimeError from the stream, not a hang in the feed loop."""
    binarizer = worker(config, chunk_frames=2,
                       binarizer_kwargs={"batch_size": 2})
    outcome = {}

    def run():
        try:
            gen = binarizer.stream_source(ArraySource(np.concatenate(
                [frames] * 4)))
            next(gen)
            os.kill(binarizer._child.pid, signal.SIGKILL)
            for _ in gen:
                pass
            outcome["result"] = "completed"
        except RuntimeError as err:
            outcome["result"] = f"raised: {err}"
        except BaseException as err:  # noqa: BLE001
            outcome["result"] = f"other: {err!r}"

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout=JOIN_S)
    assert not thread.is_alive(), "stream hung after the child was killed"
    assert outcome["result"].startswith("raised"), outcome
    binarizer.close()


def test_sync_respawn_without_prespawn(config, frames, reference):
    binarizer = worker(config, recycle_mb=1.0, chunk_frames=4,
                       prespawn=False)
    try:
        got = binarizer.process_source(ArraySource(frames[:8]))
    finally:
        binarizer.close()
    assert binarizer.recycles >= 1
    assert binarizer._spare is None
    assert_same(got, tuple(part[:8] for part in reference))
    assert not any(child["spare"] for child in binarizer.children)


def test_warm_spare_promote_bit_exact(config, frames, reference):
    """Ready-wait a spare, send it the one-frame warm-up stream, promote it
    and stream through it: results equal the in-process Binarizer and the
    warm-up outputs are discarded."""
    binarizer = worker(config, recycle_mb=1.0, chunk_frames=4)
    try:
        binarizer._warm_frame = frames[:1].copy()
        binarizer._spare = binarizer._new_child()
        binarizer._spare.wait_ready()
        binarizer._maybe_start_spare(rss=binarizer.recycle_mb + 1)
        assert binarizer._spare.warm_sent
        binarizer._promote_or_respawn()
        assert binarizer._spare is None
        promoted = binarizer._child
        assert promoted is not None and promoted.is_alive()
        got = binarizer.process_source(ArraySource(frames[:8]))
    finally:
        binarizer.close()
    assert_same(got, tuple(part[:8] for part in reference))
    assert binarizer.children[0]["spare"]


def test_eager_standing_spare(config, frames, reference):
    """The spare exists from stream start (eager mode) and results stay
    bit-exact under maximum churn; with eager off, no spare below 3/4 of
    the budget."""
    binarizer = worker(config, recycle_mb=1.0, chunk_frames=4)
    try:
        assert binarizer.prespawn_eager is True
        gen = binarizer.stream_source(ArraySource(frames[:8]))
        first = next(gen)
        assert (binarizer._spare is not None
                or binarizer.stream_stats.get("spare_failures"))
        out = list(first[2])
        for _, _, batch in gen:
            out.extend(batch)
    finally:
        binarizer.close()
    assert binarizer.recycles >= 1
    for mine, other in zip(out, reference[2][:8]):
        np.testing.assert_array_equal(mine, other)

    lazy = worker(config, recycle_mb=1e9, prespawn_eager=False)
    try:
        lazy._maybe_start_spare(0.0)
        assert lazy._spare is None
        lazy._maybe_start_spare(0.9e9)
        assert lazy._spare is not None
    finally:
        lazy.close()


def test_leftover_spare_retired_at_stream_start(config, frames, reference):
    binarizer = worker(config, chunk_frames=3)
    try:
        first = binarizer.process_source(ArraySource(frames[:6]))
        stale = binarizer._new_child()
        binarizer._spare = stale
        second = binarizer.process_source(ArraySource(frames[:6]))
    finally:
        binarizer.close()
    assert stale.proc is None
    assert binarizer._spare is None
    assert_same(second, first)


def test_compile_cache_config_plumbing(tmp_path):
    """DEVICE_WORKER_COMPILE_CACHE: unset -> the default dir; 'none' ->
    disabled; a path -> passed through. No child is spawned, and the parent
    parses the device without touching CUDA."""
    def make(extra):
        return WorkerBinarizer.from_config(Config({**CONFIG, **extra}))

    assert make({}).compile_cache == default_compile_cache()
    assert default_compile_cache().endswith("cuda_cache")
    assert make({"DEVICE_WORKER_COMPILE_CACHE": "none"}).compile_cache is None
    assert make({"DEVICE_WORKER_COMPILE_CACHE": "/tmp/custom_cache"}
                ).compile_cache == "/tmp/custom_cache"
    assert make({"DEVICE_WORKER_PRESPAWN": "false"}).prespawn is False
    assert make({}).prespawn_eager is True
    assert make({"DEVICE_WORKER_PRESPAWN_EAGER": "false"}
                ).prespawn_eager is False
    assert make({"DEVICE_WORKER_RECYCLE_MB": 512}).recycle_mb == 512.0
    assert make({"DEVICE_WORKER_CHUNK_FRAMES": 5}).chunk_frames == 5
    assert WorkerBinarizer(Config(dict(CONFIG)),
                           compile_cache="").compile_cache is None
    assert make({}).device is None  # the child resolves it: the card
    assert WorkerBinarizer(Config(dict(CONFIG)), device=torch.device(
        "cpu")).device == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        WorkerBinarizer(Config(dict(CONFIG)), device="meta")


def test_child_refuses_a_cache_dir_others_can_write(tmp_path, config,
                                                    frames):
    """The child points CUDA_CACHE_PATH at the cache dir only when it owns
    it and others cannot write it; either way it binarizes."""
    from lecturemath_tpu_torch.pipeline import device_worker

    open_dir = tmp_path / "open"
    open_dir.mkdir()
    os.chmod(open_dir, 0o777)
    for cache, expect in ((str(tmp_path / "own"), True),
                          (str(open_dir), False)):
        feed = device_worker.mp.get_context("spawn").Queue()
        result = device_worker.mp.get_context("spawn").Queue()
        feed.put(None)
        env = os.environ.pop("CUDA_CACHE_PATH", None)
        try:
            device_worker._child_main(CONFIG, "cpu", True, BATCH, cache,
                                      feed, result)
            assert result.get(timeout=60)[0] == "ready"
            assert (os.environ.get("CUDA_CACHE_PATH") == cache) is expect
        finally:
            os.environ.pop("CUDA_CACHE_PATH", None)
            if env is not None:
                os.environ["CUDA_CACHE_PATH"] = env
    assert os.path.isdir(tmp_path / "own")


# ------------------------------------------------- express through the worker

@pytest.fixture(scope="module")
def express_workspace(tmp_path_factory):
    """tests/test_torch_express.py's workspace at 16 frames: a PNG image
    list and a torch checkpoint (threshold heads over a seeded trunk) that
    both packages load."""
    import cv2

    from lecturemath_tpu_torch.models.convert import save_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.utils.synthetic import \
        threshold_binarizer_variables
    from test_torch_express import DB_XML, _write_config

    root = tmp_path_factory.mktemp("worker_express")
    (root / "db.xml").write_text(DB_XML)
    rgb, _, _, _ = synthetic_rgb_lecture(seed=11, n_frames=16, height=96,
                                         width=128, n_boards=2,
                                         glyphs_per_board=5)
    frame_dir = root / "videos" / "synth01"
    frame_dir.mkdir(parents=True)
    for t, frame in enumerate(rgb):
        cv2.imwrite(str(frame_dir / f"{t:04d}.png"), frame[:, :, ::-1])
    (root / "models").mkdir()
    config = _write_config(root, "base.conf", "out_base")
    save_checkpoint(threshold_binarizer_variables(
        FCNConfig.from_config(PipelineDriver.from_config_path(
            config, [], None, None).config), seed=1),
        str(root / "models" / "tiny.dat"))
    return root


@pytest.fixture(scope="module")
def jax_summary(express_workspace):
    """The JAX package's express in float32 on the same checkpoint, its
    summary exported under out_base."""
    import jax.numpy as jnp

    from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
    from lecturemath_tpu.pipeline.driver import PipelineDriver as JaxDriver
    from lecturemath_tpu.pipeline.express import run_lecture as jax_run

    driver = JaxDriver.from_config_path(str(express_workspace / "base.conf"),
                                        [], None, None)
    return jax_run(driver, driver.database.lectures[0],
                   JaxBinarizer.from_config(driver.config, dtype=jnp.float32))


def _conf(root, name, output, extra=""):
    from test_torch_express import _write_config

    path = _write_config(root, name, output)
    with open(path, "a") as f:
        f.write("\n" + extra)
    return path


def _assert_same_summary(ours, theirs):
    assert ours[0] == theirs[0]
    assert ours[1] == theirs[1]
    assert len(ours[2]) == len(theirs[2])
    for mine, other in zip(ours[2], theirs[2]):
        np.testing.assert_array_equal(mine, other)


def test_express_through_worker_matches(express_workspace, jax_summary):
    """DEVICE_WORKER_RECYCLE_MB in the config routes run_lecture through
    the worker (on the driver's -device); the summary equals the
    in-process run's. Then a float32 worker at maximum churn against the
    JAX package's express on the same checkpoint."""
    from lecturemath_tpu_torch.pipeline.driver import PipelineDriver
    from lecturemath_tpu_torch.pipeline.express import run_lecture

    root = express_workspace

    def run(conf, binarizer=None):
        driver = PipelineDriver.from_config_path(conf, ["-device", "cpu"],
                                                 None, None)
        return run_lecture(driver, driver.database.lectures[0], binarizer,
                           export=False)

    want = run(_conf(root, "plain.conf", "out_plain"))
    got = run(_conf(root, "worker.conf", "out_worker",
                    "DEVICE_WORKER_RECYCLE_MB = 1\n"
                    "DEVICE_WORKER_CHUNK_FRAMES = 4\n"))
    _assert_same_summary(got, want)

    conf = _conf(root, "f32.conf", "out_f32")
    binarizer = WorkerBinarizer.from_config(
        Config.from_file(conf), device="cpu", recycle_mb=1.0, chunk_frames=4,
        binarizer_kwargs={"dtype": torch.float32, "batch_size": 4})
    try:
        ours = run(conf, binarizer)
    finally:
        binarizer.close()
    assert binarizer.recycles >= 1
    _assert_same_summary(ours, jax_summary)
    assert len(ours[2]) >= 1


def test_cli_through_worker_matches_jax(express_workspace, jax_summary,
                                        capsys):
    """cli.run_pipeline with the key and -device cpu: one worker for the
    run, closed at its end; the exported summary tree is the JAX
    package's."""
    from lecturemath_tpu_torch.cli import run_pipeline
    from test_torch_express import _summary_tree

    root = express_workspace
    conf = _conf(root, "cli.conf", "out_cli",
                 "DEVICE_WORKER_RECYCLE_MB = 100000\n")
    run_pipeline.main(["run_pipeline", conf, "-device", "cpu"])
    assert "Finished" in capsys.readouterr().out
    assert _summary_tree(root, "out_cli") == _summary_tree(root, "out_base")
