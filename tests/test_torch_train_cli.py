"""The port's three training CLIs chained on the CPU (``-device cpu``) in a
small workspace, as the reference curriculum runs them: reconstruction
pretraining, the text detector warm-started from it with fresh heads, the
binarizer warm-started from that. Their ``.msgpack`` outputs load in the
JAX package; a resume file continues the epoch count; ``-mesh 1x2`` in
process and ``-mesh 2x2`` in two launched workers write the meshless
checkpoints; a missing warm start and a missing card raise."""

import os

import cv2
import numpy as np
import pytest
import torch

from lecturemath_tpu_torch.cli import (train_binarizer, train_reconstruction,
                                       train_text_detector)
from lecturemath_tpu_torch.models.convert import load_checkpoint

torch.set_num_threads(1)

DB_XML = """<AccessMath><DataBase><Name>TRDB</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Training><LectureTitle>tr01</LectureTitle></Training></Datasets>
<Lectures><Lecture><Id>tr01</Id><Title>tr01</Title><Parameters></Parameters>
<Videos><Main><Video><Path>tr01.mp4</Path></Video></Main></Videos>
</Lecture></Lectures></DataBase></AccessMath>
"""

TINY_WIDTHS = "\n".join(
    f"FCN_BINARIZER_NET_{key}_{i} = {v}"
    for key, values in (("DOWN_CONV_FILTERS", (2, 3, 4, 5, 6)),
                        ("UPSAMPLE_FILTERS", (2, 3, 4, 5, 6)),
                        ("UP_CONV_FILTERS", (2, 3, 4, 5, 6)))
    for i, v in enumerate(values, 1))


@pytest.fixture()
def workspace(tmp_path):
    rng = np.random.default_rng(4)
    annot = tmp_path / "output" / "annotations" / "TRDB_tr01"
    dirs = {name: tmp_path / name for name in ("text_imgs", "text_masks")}
    for path in [annot / "keyframes", annot / "binary", *dirs.values()]:
        path.mkdir(parents=True)
    for k in range(3):
        rgb = np.full((64, 80, 3), 220, np.uint8)
        rgb[20:40, 10:60] = rng.integers(0, 60, (20, 50, 3), np.uint8)
        binary = np.full((64, 80), 255, np.uint8)
        binary[20:40, 10:60] = np.where(rng.random((20, 50)) < 0.5, 0, 255)
        cv2.imwrite(str(annot / "keyframes" / f"{k}.png"), rgb)
        cv2.imwrite(str(annot / "binary" / f"{k}.png"), binary)
        cv2.imwrite(str(dirs["text_imgs"] / f"{k}.png"), rgb)
        cv2.imwrite(str(dirs["text_masks"] / f"{k}.png"), 255 - binary)
    (tmp_path / "db.xml").write_text(DB_XML)
    conf = tmp_path / "train.conf"
    conf.write_text("\n".join([
        f"VIDEO_DATABASE_PATH = {tmp_path}/db.xml",
        f"OUTPUT_PATH = {tmp_path}/output",
        TINY_WIDTHS,
        "FCN_BINARIZER_NET_MIDDLE_CONV_FILTERS_MIDDLE = 6",
        "FCN_BINARIZER_NET_PIXEL_FEATURES_1 = 4",
        "FCN_BINARIZER_NET_PIXEL_FEATURES_2 = 3",
        "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = 3",
        f"FCN_BINARIZER_PRETRAIN_REC_IMAGES_DIR = {dirs['text_imgs']}",
        f"FCN_BINARIZER_PRETRAIN_IMAGES_DIR = {dirs['text_imgs']}",
        f"FCN_BINARIZER_PRETRAIN_MASKS_DIR = {dirs['text_masks']}",
        "FCN_BINARIZER_PRETRAIN_REC_MEDIAN_BLUR_K = 5",
        "FCN_BINARIZER_PRETRAIN_BATCH_SIZE = 2",
        "FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 2",
        "FCN_BINARIZER_PRETRAIN_EPOCHS = 1",
        "FCN_BINARIZER_TRAIN_EPOCHS = 1",
        "FCN_BINARIZER_TRAIN_BATCH_SIZE = 2",
        "FCN_BINARIZER_TRAIN_CROP_SIZE = (32, 32)",
        "FCN_BINARIZER_TRAIN_CROP_MIN_FOREGROUND = 0.0",
        f"FCN_BINARIZER_PRETRAIN_RECONSTRUCTION_OUTPUT = {tmp_path}/rec.msgpack",
        f"FCN_BINARIZER_PRETRAIN_TEXT_OUTPUT = {tmp_path}/text.msgpack",
        "FCN_BINARIZER_PRETRAIN_USE_RECONSTRUCTION_OUTPUT = 1",
        "FCN_BINARIZER_TRAIN_USE_PRETRAIN_OUTPUT = 1",
        f"FCN_BINARIZER_TRAIN_PRETRAIN_OUTPUT = {tmp_path}/text.msgpack",
        f"FCN_BINARIZER_TRAIN_OUTPUT = {tmp_path}/bin.msgpack",
    ]))
    return tmp_path


def test_cli_chain_on_the_cpu(workspace, capsys):
    from lecturemath_tpu.core.config import Config
    from lecturemath_tpu.pipeline.binarize import (Binarizer,
                                                   load_checkpoint_variables)

    conf = str(workspace / "train.conf")
    train_reconstruction.main(["prog", conf, "-device", "cpu"])
    out = capsys.readouterr().out
    assert "Training reconstruction on 3 images" in out
    assert "[reconstruction] epoch 2/2: mse=" in out
    rec = workspace / "rec.msgpack"
    assert rec.exists() and (workspace / "rec.msgpack.epoch_2.bak").exists()
    assert (workspace / "rec.msgpack.resume").is_file()

    train_text_detector.main(["prog", conf, "-device", "cpu"])
    out = capsys.readouterr().out
    assert f"warm start from {rec} (heads reset)" in out
    assert "text_bce=" in out and "bin_bce=" in out and "rec_mse=" in out

    train_binarizer.main(["prog", conf, "training", "-device", "cpu"])
    out = capsys.readouterr().out
    assert "Training binarizer on 3 keyframe/GT pairs" in out
    assert f"warm start from {workspace}/text.msgpack" in out
    assert f"Saved: {workspace}/bin.msgpack" in out

    # every output loads in the JAX package; the binarizer's serves there
    rec_vars = load_checkpoint_variables(str(rec))
    assert "rec_conv" in rec_vars["params"]
    assert "out_conv" not in rec_vars["params"]
    for name in ("text", "bin"):
        variables = load_checkpoint_variables(str(workspace / f"{name}.msgpack"))
        assert {"out_conv", "pixels_1", "text_bn"} <= set(variables["params"])
    config = Config.from_file(conf)
    config.set("BINARIZATION_FCN_LECTURENET_DIR", str(workspace))
    config.set("BINARIZATION_FCN_LECTURENET_FILENAME", "bin.msgpack")
    binarizer = Binarizer.from_config(config)
    frame = np.full((1, 48, 64, 3), 220, np.uint8)
    assert binarizer.binarize_frames(frame).shape == (1, 48, 64)


def test_resume_continues_the_epoch_count(workspace, capsys):
    conf = workspace / "train.conf"
    train_reconstruction.main(["prog", str(conf), "-device", "cpu"])
    capsys.readouterr()
    first = (workspace / "rec.msgpack").read_bytes()
    conf.write_text(conf.read_text().replace(
        "FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 2",
        "FCN_BINARIZER_PRETRAIN_REC_EPOCHS = 3"))
    train_reconstruction.main(["prog", str(conf), "-device", "cpu"])
    out = capsys.readouterr().out
    assert "[reconstruction] resumed after epoch 2" in out
    assert "epoch 1/3" not in out and "epoch 2/3" not in out
    assert "[reconstruction] epoch 3/3" in out
    assert (workspace / "rec.msgpack").read_bytes() != first


def test_orbax_resume_directory_is_refused(workspace):
    (workspace / "rec.msgpack.resume").mkdir()
    (workspace / "rec.msgpack.resume.json").write_text(
        '{"completed_epochs": 1}')
    with pytest.raises(ValueError, match="orbax"):
        train_reconstruction.main(["prog", str(workspace / "train.conf"),
                                   "-device", "cpu"])


def test_missing_warm_start_raises(workspace):
    conf = workspace / "train.conf"
    conf.write_text(conf.read_text().replace(
        f"RECONSTRUCTION_OUTPUT = {workspace}/rec.msgpack",
        f"RECONSTRUCTION_OUTPUT = {workspace}/typo.msgpack"))
    with pytest.raises(FileNotFoundError,
                       match=f"warm-start checkpoint not found: "
                             f"{workspace}/typo.msgpack"):
        train_text_detector.main(["prog", str(conf), "-device", "cpu"])


def test_missing_warm_start_raises_before_joining_a_world(workspace,
                                                          monkeypatch):
    """Under the LM_* contract a process missing its warm start fails before
    it joins the world, not in a collective its peers wait at."""
    from lecturemath_tpu_torch.train import trainer

    def joined(*args, **kwargs):
        raise AssertionError("joined the world before the warm-start check")

    monkeypatch.setattr(trainer, "initialize_distributed_from_env", joined)
    monkeypatch.setenv("LM_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("LM_NUM_PROCESSES", "2")
    monkeypatch.setenv("LM_PROCESS_ID", "1")
    conf = workspace / "train.conf"
    conf.write_text(conf.read_text().replace(
        f"RECONSTRUCTION_OUTPUT = {workspace}/rec.msgpack",
        f"RECONSTRUCTION_OUTPUT = {workspace}/typo.msgpack"))
    with pytest.raises(FileNotFoundError, match="warm-start checkpoint"):
        train_text_detector.main(["prog", str(conf), "-device", "cpu",
                                  "-mesh", "2"])


def test_a_mesh_of_several_devices_raises(workspace):
    """The name is kept from when a mesh's model axis raised. Now the
    three CLIs chained with ``-mesh 1x2`` (two CPU shards in this process)
    and ``-mesh 2x2`` (two launched gloo workers of two CPU shards each,
    one row of each batch a worker) write the meshless checkpoints: the
    reconstruction phase with live BN, the two warm starts with frozen BN
    folded on the shards."""
    conf = workspace / "train.conf"
    for cli in (train_reconstruction, train_text_detector, train_binarizer):
        cli.main(["prog", str(conf), "-device", "cpu"])
    for mesh in ("1x2", "2x2"):
        mesh_conf = workspace / f"mesh_{mesh}.conf"
        text = conf.read_text()
        for name in ("rec", "text", "bin"):
            text = text.replace(f"{workspace}/{name}.msgpack",
                                f"{workspace}/{name}_{mesh}.msgpack")
        mesh_conf.write_text(text)
        for cli in (train_reconstruction, train_text_detector,
                    train_binarizer):
            cli.main(["prog", str(mesh_conf), "-device", "cpu", "-mesh",
                      mesh])
        for name in ("rec", "text", "bin"):
            plain = load_checkpoint(str(workspace / f"{name}.msgpack"))
            meshed = load_checkpoint(str(workspace
                                         / f"{name}_{mesh}.msgpack"))
            assert sorted(meshed) == sorted(plain), (mesh, name)
            for key, value in plain.items():
                np.testing.assert_allclose(
                    meshed[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-6,
                    err_msg=f"{mesh} {name} {key}")


def test_preload_budget_is_split_over_the_launched_workers(workspace,
                                                          monkeypatch):
    """With the available memory read as eight images' bytes, one process
    may keep half of it, four images, and keeps all three training images
    as pixels; ``-mesh 2 -device cpu`` starts two workers
    (``parallel/launch.py``), which may each keep a quarter of it, two
    images, and keep two as pixels and the third as PNG, so together they
    ask the host for no more than one process would."""
    import json

    from lecturemath_tpu_torch.parallel import launch
    from lecturemath_tpu_torch.train import dataset as dataset_module

    conf = workspace / "train.conf"
    conf.write_text(conf.read_text()
                    + "\nFCN_BINARIZER_PRETRAIN_PRELOAD_IMAGES = 1\n")
    image = 64 * 80 * 3
    monkeypatch.setattr(dataset_module, "available_memory",
                        lambda: 8 * image)
    kept = []
    real_preload = dataset_module.LectureNetDataset.preload

    def preload(self, verbose=False):
        real_preload(self, verbose)
        kept.append(dict(self.data_stats,
                         budget=dataset_module.preload_budget()))

    monkeypatch.setattr(dataset_module.LectureNetDataset, "preload", preload)
    monkeypatch.delenv("LM_LOCAL_PROCESSES", raising=False)
    monkeypatch.delenv("LM_NUM_PROCESSES", raising=False)
    train_reconstruction.main(["prog", str(conf), "-device", "cpu"])
    assert kept == [dict(kept[0], budget=4 * image, pairs_pixels=3,
                         pairs_png=0, bytes_kept=3 * image)]

    out = workspace / "budgets"
    out.mkdir()
    monkeypatch.setenv("LM_STUB_AVAILABLE", str(8 * image))
    monkeypatch.setenv("LM_OUT_DIR", str(out))
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(__file__))
    real_launch = launch.launch_local
    monkeypatch.setattr(launch, "launch_local",
                        lambda module, args, n, device: real_launch(
                            "mp_budget_worker", args, n, device))
    train_reconstruction.main(["prog", str(conf), "-device", "cpu",
                               "-mesh", "2"])
    for rank in range(2):
        stats = json.loads((out / f"{rank}.json").read_text())
        assert stats["budget"] == 2 * image
        assert (stats["pairs_pixels"], stats["pairs_png"]) == (2, 1), stats


@pytest.mark.parametrize("env, share", [
    ({}, 1), ({"LM_LOCAL_PROCESSES": "2"}, 2), ({"LM_NUM_PROCESSES": "4"}, 4),
    ({"LM_LOCAL_PROCESSES": "2", "LM_NUM_PROCESSES": "8"}, 2)],
    ids=["alone", "launched", "world", "launched-in-world"])
def test_preload_budget_splits_over_the_hosts_processes(monkeypatch, env,
                                                        share):
    """Half the available memory over the launcher's workers of this host,
    else over a joined world's processes, else kept whole."""
    from lecturemath_tpu_torch.train import dataset as dataset_module

    monkeypatch.setattr(dataset_module, "available_memory", lambda: 8000)
    for name in ("LM_LOCAL_PROCESSES", "LM_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert dataset_module.preload_budget() == 4000 // share


def test_a_one_device_mesh_trains_in_process(workspace):
    """-mesh 1x1 without LM_COORDINATOR trains in this process, exactly as
    without a mesh."""
    conf = workspace / "train.conf"
    mesh_conf = workspace / "mesh.conf"
    mesh_conf.write_text(conf.read_text().replace(
        f"RECONSTRUCTION_OUTPUT = {workspace}/rec.msgpack",
        f"RECONSTRUCTION_OUTPUT = {workspace}/rec_mesh.msgpack"))
    train_reconstruction.main(["prog", str(conf), "-device", "cpu"])
    train_reconstruction.main(["prog", str(mesh_conf), "-device", "cpu",
                               "-mesh", "1x1"])
    plain = load_checkpoint(str(workspace / "rec.msgpack"))
    meshed = load_checkpoint(str(workspace / "rec_mesh.msgpack"))
    assert sorted(meshed) == sorted(plain)
    for key, value in plain.items():
        assert torch.equal(meshed[key], value), key


@pytest.mark.parametrize("cli", [train_reconstruction, train_text_detector,
                                 train_binarizer])
def test_without_a_card_each_cli_raises(workspace, cli):
    from lecturemath_tpu_torch.core.backend_probe import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs train on it")
    with pytest.raises(BackendUnavailable, match="-device cpu"):
        cli.main(["prog", str(workspace / "train.conf")])
