"""The port's data axis across processes: 2 gloo processes on the CPU under
the LM_COORDINATOR / LM_NUM_PROCESSES / LM_PROCESS_ID contract, one CPU
device each (a 2x1 mesh), against the port's single-process run and the
JAX package's 8-device data-axis mesh (the conftest's virtual CPUs).

- Stage 01 through the sharded Binarizer: every process receives every
  frame, bit-identical to the meshless port and to the JAX mesh output.
- 3 data-parallel SGD steps of the binarizer phase (cross-replica BN,
  weighted terms over the global batch, the clip after the gradient
  all-reduce): the per-step losses and the final weights and BN running
  statistics equal both references within rtol 1e-5 / atol 1e-6 (fp32;
  the reductions sum in another order across the process boundary).
- The model axis (channels and height) on 1x2 meshes, whose model group
  spans the two processes, and 2x2 meshes, a group in each: every process
  gets every frame of the meshless port (binaries equal but at pixels
  whose logit lies within NEAR of the threshold); the same for the
  stage-01 Binarizer over seeded weights whose logits read every layer.
- Training over the model axis on the same 1x2 and 2x2 meshes (live BN,
  frozen BN folded, weighted terms with the clip): every process's losses
  and assembled state equal the meshless port's within rtol 1e-5 / atol
  1e-6, and the checkpoint process 0 alone writes loads in the JAX
  package.
- ``cli.binarize -mesh 2`` and ``-mesh 1x2`` run as 2 processes write the
  single-process CLI's artifact byte for byte; ``train_reconstruction -mesh 2`` in one
  process launches its 2 workers, and a failing worker fails the CLI.

Every world runs under its own deadline (WORLD_DEADLINE_S) and is killed
when it passes, so a hung rendezvous fails one test, not the suite.
"""

import os
import pickle
import subprocess
import sys
import time

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from lecturemath_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.train.trainer import Trainer as JaxTrainer
from lecturemath_tpu_torch.cli import binarize, train_reconstruction
from lecturemath_tpu_torch.models.convert import (
    flax_variables_from_state_dict, load_checkpoint, save_checkpoint,
    state_dict_from_flax)
from lecturemath_tpu_torch.parallel.launch import free_port
from lecturemath_tpu_torch.utils.synthetic import (
    synthetic_rgb_lecture, threshold_binarizer_variables)

import _torch_mp_workload as workload
from test_torch_stages import DB_XML, SETTINGS, TINY_KEYS

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD_DEADLINE_S = 120
RTOL, ATOL = 1e-5, 1e-6


def run_world(argv, n=2, extra_env=None, deadline_s=WORLD_DEADLINE_S):
    """``argv`` as ``n`` processes of one gloo world; returns their
    (exit code, output). Every process is killed at the deadline."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, LM_COORDINATOR=f"127.0.0.1:{port}",
                   LM_NUM_PROCESSES=str(n), LM_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
        env.update({key: value.format(rank=rank)
                    for key, value in (extra_env or {}).items()})
        procs.append(subprocess.Popen(argv, env=env, cwd=REPO,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    end = time.monotonic() + deadline_s
    results = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=max(1.0,
                                                  end - time.monotonic()))
            results.append((proc.returncode, out))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{argv} passed its {deadline_s} s deadline")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


# ------------------------------------------------------------ the workload

@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """Where the worker pair saves its results and checkpoints."""
    return tmp_path_factory.mktemp("mp_torch")


@pytest.fixture(scope="module")
def world(world_dir):
    """The worker pair's saved results, one dict a process."""
    out = world_dir
    results = run_world([sys.executable, os.path.join(HERE,
                                                      "mp_torch_worker.py")],
                        extra_env={"LM_OUT_PATH": str(out / "p{rank}.npz")})
    for code, text in results:
        assert code == 0, text[-3000:]
    return [dict(np.load(out / f"p{rank}.npz")) for rank in range(2)]


# the bf16 input rounds to 2^-8 relative, the output once more
BN_TOLERANCE = {"f32": dict(rtol=1e-5, atol=1e-5),
                "bf16": dict(rtol=2 ** -7, atol=2 ** -6)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_replica_batch_norm_equals_full_batch(world, dtype):
    """Each process normalizes its 4 rows of an 8-row batch with the
    global statistics: its output and input gradient are torch's
    BatchNorm2d's on the whole batch, the scale and shift gradients sum to
    torch's, and the running statistics (unbiased variance at n = 8*6*7)
    are torch's, on both processes."""
    ref = workload.run_batch_norm(
        torch.float32 if dtype == "f32" else torch.bfloat16)
    tol = BN_TOLERANCE[dtype]
    for rank in range(2):
        got = {key.split("/")[1]: value for key, value in world[rank].items()
               if key.startswith(f"bn_{dtype}/")}
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_allclose(got["y"], ref["y"][rows], **tol)
        np.testing.assert_allclose(got["dx"], ref["dx"][rows], **tol)
        for key in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    for key in ("dweight", "dbias"):
        np.testing.assert_allclose(
            world[0][f"bn_{dtype}/{key}"] + world[1][f"bn_{dtype}/{key}"],
            ref[key], rtol=1e-4, atol=1e-4, err_msg=key)


def _jax_config():
    c = workload.NET_CONFIG
    return jfcn.FCNConfig(
        in_channels=c.in_channels, down_filters=c.down_filters,
        mid_filters=c.mid_filters, upsample_filters=c.upsample_filters,
        up_filters=c.up_filters, pixel_features=c.pixel_features,
        kernel_size=c.kernel_size, pixel_kernel_size=c.pixel_kernel_size)


def test_sharded_binarizer_gives_every_process_all_frames(world):
    frames = workload.make_frames()
    meshless = workload.run_inference(frames)
    variables = flax_variables_from_state_dict(
        threshold_binarizer_variables(workload.NET_CONFIG))
    jax_bin = JaxBinarizer(jfcn.FCNLectureNet(_jax_config(),
                                              dtype=jnp.float32),
                           variables, batch_size=len(frames),
                           mesh=jax_make_mesh(JaxMeshSpec(8, 1)),
                           upload_format="rgb")
    theirs = jax_bin.binarize_frames(frames)
    np.testing.assert_array_equal(meshless, theirs)
    assert (theirs == 255).any() and (theirs == 0).any()
    for rank in range(2):
        np.testing.assert_array_equal(world[rank]["binary"], theirs)
        # 2 processes x 2 CPU replicas
        np.testing.assert_array_equal(world[rank]["binary_2x2"], theirs)


# binaries may differ only where the meshless logit lies this close to the
# threshold's (sharded layers sum in another order); at most MAX_NEAR of
# the pixels are that close, and the sigmoid * 255 maps differ there by
# one level at most
NEAR, MAX_NEAR = 1e-5, 1e-3
THRESHOLD_LOGIT = np.log(128 / 127)


@pytest.mark.parametrize("mesh_text", ["1x2", "2x2"])
@pytest.mark.parametrize("flag", workload.MODEL_AXIS_FLAGS)
def test_model_axis_gives_every_process_all_frames(world, mesh_text, flag):
    """Channels or height over the model axis, its group across the two
    processes (1x2: gathers, the transposed convs' sum and the halos travel
    over gloo) or inside each (2x2): every process gets every frame, the
    meshless port's."""
    frames = workload.make_frames()
    binary, level = workload.run_model_axis(frames, None)
    near = np.abs(workload.model_axis_logits(frames)
                  - THRESHOLD_LOGIT) < NEAR
    assert near.mean() <= MAX_NEAR
    for rank in range(2):
        got = world[rank][f"{flag}_{mesh_text}/binary"]
        assert got.shape == binary.shape
        assert not ((got != binary) & ~near).any(), rank
        got = world[rank][f"{flag}_{mesh_text}/map"].astype(int)
        assert np.abs(got - level.astype(int)).max() <= 1
        assert np.mean(got != level) <= MAX_NEAR
    # the stage-01 Binarizer, channel-sharded across the processes; the
    # threshold heads read no trunk channel, so bit for bit
    np.testing.assert_array_equal(world[0][f"binary_{mesh_text}"],
                                  workload.run_inference(frames))
    np.testing.assert_array_equal(world[1][f"binary_{mesh_text}"],
                                  world[0][f"binary_{mesh_text}"])


@pytest.mark.parametrize("mesh_text", ["1x2", "2x2"])
def test_binarizer_model_axis_reaches_the_trunk_across_processes(
        world, mesh_text):
    """The stage-01 Binarizer channel-sharded across the processes (1x2)
    or inside each (2x2), over the seeded start weights, whose logits read
    every trunk layer: every process gets the meshless Binarizer's frames,
    but where the meshless logit lies within NEAR of the threshold."""
    frames = workload.make_frames()
    expected = workload.run_inference(frames, None, "start")
    near = np.abs(workload.model_axis_logits(frames)
                  - THRESHOLD_LOGIT) < NEAR
    assert near.mean() <= MAX_NEAR
    assert (expected == 255).any() and (expected == 0).any()
    for rank in range(2):
        got = world[rank][f"binary_{mesh_text}/start"]
        assert got.shape == expected.shape
        assert not ((got != expected) & ~near).any(), rank


def _jax_training(case):
    use_weights, clip_norm = workload.TRAIN_CASES[case]
    variables = flax_variables_from_state_dict(workload.start_state_dict())
    trainer = JaxTrainer(jfcn.FCNLectureNet(_jax_config(),
                                            dtype=jnp.float32),
                         workload.LEARNING_RATE, phase="binarizer",
                         mesh=jax_make_mesh(JaxMeshSpec(8, 1)),
                         use_weights=use_weights, clip_norm=clip_norm)
    state = trainer.init_state(None, variables=jax.tree.map(jnp.asarray,
                                                            variables))
    batch = workload.make_train_batch()
    if not use_weights:
        batch.pop("weights")
    losses = []
    for _ in range(workload.TRAIN_STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["total"]))
    final = state_dict_from_flax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    return losses, {key: value.numpy() for key, value in final.items()}


@pytest.mark.parametrize("case", list(workload.TRAIN_CASES))
def test_data_parallel_steps_match_meshless_and_jax(world, case):
    ours_losses, ours_state = workload.run_training(case)
    jax_losses, jax_state = _jax_training(case)
    np.testing.assert_allclose(ours_losses, jax_losses, rtol=RTOL)
    start = workload.start_state_dict()
    moved = 0
    for rank in range(2):
        got = world[rank]
        np.testing.assert_allclose(got[f"{case}/losses"], ours_losses,
                                   rtol=RTOL, err_msg=f"process {rank}")
        np.testing.assert_allclose(got[f"{case}/losses"], jax_losses,
                                   rtol=RTOL, err_msg=f"process {rank}")
        for key, value in jax_state.items():
            if key.endswith("num_batches_tracked"):
                continue
            for reference in (value, ours_state[key]):
                np.testing.assert_allclose(
                    got[f"{case}/{key}"], reference, rtol=RTOL, atol=ATOL,
                    err_msg=f"process {rank} {key}")
            moved += not np.array_equal(got[f"{case}/{key}"],
                                        start[key].numpy())
    # the running statistics and the weights both moved
    assert moved > 0
    assert not np.array_equal(
        world[0][f"{case}/conv_down_block_1.1.running_var"],
        start["conv_down_block_1.1.running_var"].numpy())


@pytest.mark.parametrize("mesh_text", ["1x2", "2x2"])
@pytest.mark.parametrize("case", ["live", "folded", "clipped"])
def test_model_axis_training_across_processes(world, world_dir, mesh_text,
                                              case):
    """3 steps on 1x2 (the model group spans the processes: gathers,
    partial sums, the fold's BN scales and the replicated gradients' sum
    travel over gloo) and on 2x2 (a group in each process, the BN and the
    gradient average over the data group): both processes get the
    meshless losses and state, and process 0's checkpoint, the only one
    written, holds that state in the JAX package."""
    from lecturemath_tpu.pipeline.binarize import load_checkpoint_variables

    losses, state = workload.run_axis_training(case)
    for rank in range(2):
        got = world[rank]
        np.testing.assert_allclose(got[f"axis_{mesh_text}_{case}/losses"],
                                   losses, rtol=RTOL,
                                   err_msg=f"process {rank}")
        for key, value in state.items():
            np.testing.assert_allclose(
                got[f"axis_{mesh_text}_{case}/{key}"], value, rtol=RTOL,
                atol=ATOL, err_msg=f"process {rank} {key}")
    written = [world_dir / f"p{rank}.npz.{mesh_text}.{case}.msgpack"
               for rank in range(2)]
    assert written[0].exists() and not written[1].exists()
    loaded = state_dict_from_flax(load_checkpoint_variables(
        str(written[0])))
    assert "out_conv" not in loaded
    for key, value in loaded.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), state[key], rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_weighted_loss_is_the_global_ratio(world):
    """The halves' weight sums differ 4x, so the average of per-process
    ratios would be another loss: the processes' step-1 weighted loss is
    the global one."""
    batch = workload.make_train_batch()
    halves = batch["weights"][:4].sum(), batch["weights"][4:].sum()
    assert halves[1] > 3 * halves[0]
    np.testing.assert_allclose(world[0]["weighted/losses"],
                               world[1]["weighted/losses"], rtol=0)


# --------------------------------------------------------------- the CLIs

@pytest.fixture()
def lecture_workspace(tmp_path):
    """An 8-frame image-list lecture, a tiny threshold checkpoint, and one
    config per output tree."""
    (tmp_path / "db.xml").write_text(DB_XML.format(video="synth01"))
    rgb, _, _, _ = synthetic_rgb_lecture(seed=3, n_frames=9, height=64,
                                         width=96, n_boards=1,
                                         glyphs_per_board=4)
    frames = tmp_path / "videos" / "synth01"
    frames.mkdir(parents=True)
    for t, frame in enumerate(rgb):
        cv2.imwrite(str(frames / f"{t:04d}.png"), frame[:, :, ::-1])
    (tmp_path / "models").mkdir()
    lines = [f"VIDEO_DATABASE_PATH = {tmp_path}/db.xml",
             f"VIDEO_FILES_PATH = {tmp_path}/videos",
             f"BINARIZATION_FCN_LECTURENET_DIR = {tmp_path}/models",
             "BINARIZATION_FCN_LECTURENET_FILENAME = tiny.dat",
             "UPLOAD_FORMAT = rgb"]
    lines += SETTINGS + [f"{k} = {v}" for k, v in TINY_KEYS.items()]
    configs = {}
    for name in ("single", "mesh"):
        configs[name] = tmp_path / f"{name}.conf"
        configs[name].write_text("\n".join(
            lines + [f"OUTPUT_PATH = {tmp_path}/out_{name}"]))
    from lecturemath_tpu_torch.core.config import Config
    from lecturemath_tpu_torch.models.fcn_lecturenet import FCNConfig

    net_config = FCNConfig.from_config(Config.from_file(str(configs["mesh"])))
    save_checkpoint(threshold_binarizer_variables(net_config, seed=2),
                    str(tmp_path / "models" / "tiny.dat"))
    return tmp_path, configs


def test_binarize_cli_mesh_across_two_processes(lecture_workspace):
    root, configs = lecture_workspace
    binarize.main(["binarize", str(configs["single"]), "-device", "cpu"])
    results = run_world([sys.executable, "-m",
                         "lecturemath_tpu_torch.cli.binarize",
                         str(configs["mesh"]), "-mesh", "2",
                         "-device", "cpu"])
    for code, text in results:
        assert code == 0, text[-3000:]
        assert "Finished" in text
    artifact = os.path.join("temporal", "tempo_binary_synth01.dat")
    single = (root / "out_single" / artifact).read_bytes()
    assert (root / "out_mesh" / artifact).read_bytes() == single
    times, indices, frames = pickle.loads(single)
    assert len(indices) == 9 and len(frames) == 9


def test_binarize_cli_model_axis_across_two_processes(lecture_workspace):
    """-mesh 1x2 in 2 processes, one CPU shard each: the model group spans
    the processes, and both write the meshless CLI's artifact."""
    root, configs = lecture_workspace
    binarize.main(["binarize", str(configs["single"]), "-device", "cpu"])
    results = run_world([sys.executable, "-m",
                         "lecturemath_tpu_torch.cli.binarize",
                         str(configs["mesh"]), "-mesh", "1x2",
                         "-device", "cpu"])
    for code, text in results:
        assert code == 0, text[-3000:]
        assert "1-way data axis, 2-way model axis" in text
    artifact = os.path.join("temporal", "tempo_binary_synth01.dat")
    assert (root / "out_mesh" / artifact).read_bytes() == \
        (root / "out_single" / artifact).read_bytes()


@pytest.fixture()
def train_workspace(tmp_path):
    """Six 48x48 images for the reconstruction phase, batch 2, 2 epochs;
    one config writing ``single.msgpack`` and one ``mesh.msgpack``."""
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(5)
    for k in range(6):
        rgb = np.full((48, 48, 3), 210, np.uint8)
        rgb[8:40, 6:42] = rng.integers(0, 90, (32, 36, 3), np.uint8)
        cv2.imwrite(str(images / f"{k}.png"), rgb)
    widths = [f"FCN_BINARIZER_NET_{key}_{i} = {v}"
              for key, values in (("DOWN_CONV_FILTERS", (2, 3, 4, 5, 6)),
                                  ("UPSAMPLE_FILTERS", (2, 3, 4, 5, 6)),
                                  ("UP_CONV_FILTERS", (2, 3, 4, 5, 6)))
              for i, v in enumerate(values, 1)]
    lines = widths + [
        "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE = 6",
        f"FCN_BINARIZER_PRETRAIN_REC_IMAGES_DIR = {images}",
        "FCN_BINARIZER_PRETRAIN_REC_MEDIAN_BLUR_K = 5",
        "FCN_BINARIZER_PRETRAIN_BATCH_SIZE = 2",
        "FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 2",
        "FCN_BINARIZER_TRAIN_CROP_SIZE = (32, 32)",
        "FCN_BINARIZER_TRAIN_CROP_MIN_FOREGROUND = 0.0",
        "TRAIN_PREFETCH_BATCHES = 0"]
    configs = {}
    for name in ("single", "mesh"):
        configs[name] = tmp_path / f"{name}.conf"
        configs[name].write_text("\n".join(lines + [
            "FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT = "
            f"{tmp_path}/{name}.msgpack"]))
    return tmp_path, configs


def test_train_cli_mesh_launches_its_workers(train_workspace, capfd):
    root, configs = train_workspace
    train_reconstruction.main(["prog", str(configs["single"]),
                               "-device", "cpu"])
    train_reconstruction.main(["prog", str(configs["mesh"]), "-device", "cpu",
                               "-mesh", "2"])
    out = capfd.readouterr().out
    # each worker reports its epochs; only process 0 writes
    assert out.count("[reconstruction] epoch 2/2") == 3
    expected = load_checkpoint(str(root / "single.msgpack"))
    got = load_checkpoint(str(root / "mesh.msgpack"))
    assert sorted(got) == sorted(expected)
    for key, value in expected.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert sorted(p.name for p in root.iterdir()
                  if p.name.startswith("mesh.msgpack")) == [
        "mesh.msgpack", "mesh.msgpack.epoch_2.bak", "mesh.msgpack.resume",
        "mesh.msgpack.resume.json"]


def test_train_cli_fails_when_a_worker_fails(train_workspace):
    """A batch of 3 rows does not split over 2 processes: each worker
    raises, and the launching CLI exits with a worker's code."""
    root, configs = train_workspace
    conf = configs["mesh"]
    conf.write_text(conf.read_text().replace(
        "PRETRAIN_BATCH_SIZE = 2", "PRETRAIN_BATCH_SIZE = 3"))
    with pytest.raises(SystemExit) as raised:
        train_reconstruction.main(["prog", str(conf), "-device", "cpu",
                                   "-mesh", "2"])
    assert raised.value.code != 0
    assert not (root / "mesh.msgpack").exists()
