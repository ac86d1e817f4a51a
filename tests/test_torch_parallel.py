"""The port's data-axis mesh in one process, against the JAX package's:
``MeshSpec.resolve`` and ``local_row_slice`` over a grid of meshes, process
counts and row counts (the JAX side with its process count and index
monkeypatched, as tests/test_parallel.py does), stage 01 through a
4-replica CPU mesh, ``ShardedBinarizer``, and the model axis's entry
points running for inference (its numbers are
tests/test_torch_model_axis.py's) and for training (its numbers are
tests/test_torch_model_axis_train.py's). fp32 on the CPU at TINY widths;
the binaries are compared bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.parallel import mesh as jmesh
from lecturemath_tpu.parallel.inference import \
    ShardedBinarizer as JaxShardedBinarizer
from lecturemath_tpu.pipeline.binarize import Binarizer as JaxBinarizer
from lecturemath_tpu.pipeline.video import ArraySource as JaxArraySource
from lecturemath_tpu.utils.synthetic import threshold_binarizer_variables
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import state_dict_from_flax
from lecturemath_tpu_torch.parallel import mesh as tmesh
from lecturemath_tpu_torch.parallel.inference import ShardedBinarizer
from lecturemath_tpu_torch.pipeline import binarize as port_binarize
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.video import ArraySource
from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)
N_DEVICES = 8  # the conftest's virtual CPU devices


def _outcome(fn):
    """fn()'s value, or ('raises', the error's first words)."""
    try:
        return fn()
    except ValueError as err:
        return ("raises", str(err).split(":")[0])


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_resolve_matches_jax(n_devices):
    for data in (-1, 1, 2, 3, 8, 9):
        spec = (data, 1)
        ours = _outcome(lambda: tmesh.MeshSpec(*spec).resolve(n_devices))
        theirs = _outcome(lambda: jmesh.MeshSpec(*spec).resolve(n_devices))
        if isinstance(theirs, jmesh.MeshSpec):
            theirs = (theirs.data, theirs.model)
            ours = (ours.data, ours.model)
        assert ours == theirs, (spec, n_devices)


def _port_mesh(monkeypatch, data, count, index):
    """The port's make_mesh as process ``index`` of ``count`` sees it, each
    process offering N_DEVICES / count CPU devices."""
    per = N_DEVICES // count
    monkeypatch.setattr(tmesh, "process_count", lambda: count)
    monkeypatch.setattr(tmesh, "process_index", lambda: index)
    monkeypatch.setattr(tmesh, "_gather_counts",
                        lambda n, device: [n] * count)
    return tmesh.make_mesh(tmesh.MeshSpec(data, 1), [CPU] * per)


@pytest.mark.parametrize("data", [1, 2, 4, 8])
@pytest.mark.parametrize("count", [1, 2, 4])
def test_local_row_slice_matches_jax(monkeypatch, data, count):
    jax_mesh = jmesh.make_mesh(jmesh.MeshSpec(data, 1))
    for index in range(count):
        ours_mesh = _port_mesh(monkeypatch, data, count, index)
        assert ours_mesh.world_size == count and ours_mesh.rank == index
        assert ours_mesh.device_count == N_DEVICES
        monkeypatch.setattr(jax, "process_count", lambda: count)
        monkeypatch.setattr(jax, "process_index", lambda: index)
        for rows in (4, 6, 8, 12, 16):
            ours = _outcome(lambda: tmesh.local_row_slice(ours_mesh, rows))
            theirs = _outcome(lambda: jmesh.local_row_slice(jax_mesh, rows))
            assert ours == theirs, (data, count, index, rows)
    # both errors occur on the grid: rows not divisible, and a sub-mesh
    # of a multi-process run
    if data == 8:
        assert _outcome(lambda: tmesh.local_row_slice(ours_mesh, 12))[0] \
            == "raises"
    if count > 1 and data < N_DEVICES:
        assert "span all" in str(pytest.raises(
            ValueError, tmesh.local_row_slice, ours_mesh, 8).value)


def test_make_mesh_takes_the_first_devices_in_process_order(monkeypatch):
    mesh = _port_mesh(monkeypatch, 4, 2, 1)
    # process 1's 4 devices come after process 0's, past the 4-device mesh
    assert [p for p, _ in mesh.devices] == [0, 0, 0, 0]
    assert mesh.local_devices == ()
    with pytest.raises(ValueError, match="owns no device"):
        tmesh.check_mesh(mesh)
    mesh = _port_mesh(monkeypatch, -1, 2, 1)
    assert mesh.shape == {"data": 8, "model": 1}
    assert len(mesh.local_devices) == 4


@pytest.fixture(scope="module")
def threshold_weights():
    cfg = jfcn.FCNConfig(**TINY)
    variables = threshold_binarizer_variables(cfg)
    return cfg, variables, state_dict_from_flax(variables)


def _port_model(state_dict):
    model = tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY))
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def ragged():
    rgb, _, _, _ = synthetic_rgb_lecture(seed=6, n_frames=11, height=32,
                                         width=64, glyphs_per_board=3,
                                         glyph_size=(12, 14))
    return rgb


@pytest.mark.parametrize("async_drain", [True, False])
def test_binarizer_on_four_cpu_replicas(ragged, threshold_weights,
                                        async_drain, monkeypatch):
    """11 frames in batches of 4 (the last holds 3): the 4x1 mesh's stream
    equals the meshless port's and the JAX Binarizer's on a 4x1 mesh."""
    cfg, variables, state_dict = threshold_weights
    mesh = tmesh.make_mesh(tmesh.MeshSpec(4, 1), [CPU] * 4)
    kwargs = dict(batch_size=3, upload_format="rgb")
    if not async_drain:
        # the port drains inline in a world of more than one process
        monkeypatch.setattr(port_binarize, "process_count", lambda: 2)
    sharded = Binarizer(_port_model(state_dict), mesh=mesh, **kwargs)
    assert sharded.batch_size == 4 and len(sharded._replicas) == 4
    meshless = Binarizer(_port_model(state_dict), device="cpu",
                         **dict(kwargs, batch_size=4))
    jax_bin = JaxBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32),
                           variables, mesh=jmesh.make_mesh(
                               jmesh.MeshSpec(4, 1)),
                           async_drain=async_drain, **kwargs)
    ours = sharded.process_source(ArraySource(ragged, fps=1.0))
    plain = meshless.process_source(ArraySource(ragged, fps=1.0))
    theirs = jax_bin.process_source(JaxArraySource(ragged, fps=1.0))
    assert ours[0] == plain[0] == theirs[0]
    assert ours[1] == plain[1] == theirs[1] == list(range(11))
    assert len(ours[2]) == 11
    for a, b, c in zip(*(result[2] for result in (ours, plain, theirs))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert any((frame == 255).any() for frame in ours[2])
    # binarize_frames: a ragged call pads to the data axis and crops back
    np.testing.assert_array_equal(sharded.binarize_frames(ragged[:5]),
                                  meshless.binarize_frames(ragged[:5]))


@pytest.mark.parametrize("n_frames", [8, 5])
def test_sharded_binarizer_matches_jax(ragged, threshold_weights, n_frames):
    cfg, variables, state_dict = threshold_weights
    ours = ShardedBinarizer(_port_model(state_dict).eval(),
                            tmesh.make_mesh(tmesh.MeshSpec(4, 1), [CPU] * 4))
    theirs = JaxShardedBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32),
                                 variables,
                                 jmesh.make_mesh(jmesh.MeshSpec(4, 1)))
    got = ours.binarize_frames(ragged[:n_frames])
    assert got.shape == (n_frames, 32, 64)
    np.testing.assert_array_equal(got, theirs.binarize_frames(
        ragged[:n_frames]))


def test_sharded_binarizer_full_output(ragged, threshold_weights):
    """force_binary=False: the thresholdless sigmoid*255 map of every row,
    as the meshless full-output binarizer gives it."""
    _, _, state_dict = threshold_weights
    model = _port_model(state_dict).eval()
    ours = ShardedBinarizer(model, tmesh.make_mesh(tmesh.MeshSpec(2, 1),
                                                   [CPU] * 2),
                            force_binary=False)
    got = ours.binarize_frames(ragged[:3])
    expected = tfcn.make_binarizer(model, force_binary=False)(
        torch.from_numpy(ragged[:3]))[0].numpy()
    np.testing.assert_array_equal(got, expected)
    assert not np.isin(got, (0, 255)).all()  # not thresholded


def test_model_axis_raises_item_10b(threshold_weights, tmp_path,
                                    monkeypatch):
    """The name is kept from when training over the model axis raised.
    Now the Trainer on a 1x2 CPU mesh trains (live BN, then frozen BN
    folded) and writes the meshless checkpoint, and the training CLIs'
    launcher starts D workers on the CPU and D x M on cards (one card
    each), none for one data position, raising past the visible cards."""
    from lecturemath_tpu_torch.models.convert import load_checkpoint
    from lecturemath_tpu_torch.parallel import launch
    from lecturemath_tpu_torch.train.trainer import Trainer

    _, _, state_dict = threshold_weights
    rng = np.random.default_rng(3)
    batch = {"image": rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32),
             "target": (rng.random((2, 32, 64, 1)) > 0.5).astype(np.float32),
             "text_mask": (rng.random((2, 32, 64, 1)) > 0.5).astype(
                 np.float32)}
    for frozen in (False, True):
        paths = []
        for mesh in (None, tmesh.make_mesh(tmesh.MeshSpec(1, 2), [CPU] * 2)):
            trainer = Trainer(_port_model(state_dict), 0.1, freeze_bn=frozen,
                              fold_frozen_bn=frozen, prefetch_depth=0,
                              device="cpu", mesh=mesh)
            assert len(trainer.shards) == (1 if mesh is None else 2)
            for _ in range(2):
                trainer.step(batch)
            paths.append(str(tmp_path / f"{frozen}_{mesh is None}.msgpack"))
            trainer.save(paths[-1])
        plain, sharded = (load_checkpoint(path) for path in paths)
        assert sorted(sharded) == sorted(plain)
        for key, value in plain.items():
            np.testing.assert_allclose(sharded[key].numpy(), value.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        assert not torch.equal(plain["conv_out.0.weight"],
                               state_dict["conv_out.0.weight"])
    assert launch.workers_needed(tmesh.MeshSpec(2, 2), "cpu") == 2
    assert launch.workers_needed(tmesh.MeshSpec(1, 2), "cpu") == 0
    monkeypatch.setattr(launch, "visible_cards", lambda: list("0123"))
    assert launch.workers_needed(tmesh.MeshSpec(2, 2), None) == 4
    assert launch.workers_needed(tmesh.MeshSpec(1, 4), None) == 0
    with pytest.raises(ValueError, match="needs 6 devices, have 4"):
        launch.workers_needed(tmesh.MeshSpec(3, 2), None)


def test_model_axis_runs_for_inference(ragged, threshold_weights):
    """make_mesh(2x2), its spec tree, shard_params, the stage-01 Binarizer
    and both ShardedBinarizer uses of the model axis give the meshless
    frames (the threshold heads read no trunk channel, so bit for bit)."""
    _, _, state_dict = threshold_weights
    mesh = tmesh.make_mesh(tmesh.MeshSpec(2, 2), [CPU] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert tmesh.local_model_groups(mesh) == [[(0, 0), (1, 1)],
                                              [(0, 2), (1, 3)]]
    specs = tmesh.params_pspec_tree(state_dict, mesh)
    assert specs["conv_down_block_1.0.weight"] == ("model", None, None, None)
    assert specs["conv_down_block_2.0.weight"] == ()     # 3 channels
    shards = tmesh.shard_params(mesh, _port_model(state_dict))
    assert [s.conv_down_block_1[0].weight.shape[0] for s in shards] == [1] * 4
    expected = ShardedBinarizer(_port_model(state_dict),
                                tmesh.make_mesh(tmesh.MeshSpec(1, 1), [CPU])
                                ).binarize_frames(ragged[:4])
    for kwargs in ({"shard_params_over_model": True},
                   {"shard_spatial": True}):
        got = ShardedBinarizer(_port_model(state_dict), mesh,
                               **kwargs).binarize_frames(ragged[:4])
        np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(
        Binarizer(_port_model(state_dict), mesh=mesh,
                  upload_format="rgb").binarize_frames(ragged[:4]),
        expected)
    assert tmesh.params_pspec_tree({"w": torch.zeros(2)},
                                   tmesh.make_mesh(tmesh.MeshSpec(2, 1),
                                                   [CPU] * 2)) == {"w": ()}


def test_trainer_takes_one_device_a_process(threshold_weights):
    """Data-parallel training is one device a process (one data position's
    shards on a model axis): a mesh with two data positions in this process
    is refused, a 1x1 mesh without a world trains as without a mesh."""
    from lecturemath_tpu_torch.train.trainer import Trainer

    _, _, state_dict = threshold_weights
    for spec in (tmesh.MeshSpec(2, 1), tmesh.MeshSpec(2, 2)):
        with pytest.raises(ValueError, match="one device a process"):
            Trainer(_port_model(state_dict), 0.1, mesh=tmesh.make_mesh(
                spec, [CPU] * (spec.data * spec.model)))
    trainer = Trainer(_port_model(state_dict), 0.1,
                      mesh=tmesh.make_mesh(tmesh.MeshSpec(1, 1), [CPU]))
    assert trainer.device == CPU and trainer._group is None
    assert trainer.model.bn_group is None


def test_shard_batch_and_replicate():
    mesh = tmesh.make_mesh(tmesh.MeshSpec(2, 1), [CPU] * 2)
    batch = {"image": np.arange(12, dtype=np.float32).reshape(4, 3),
             "target": np.arange(4)}
    parts = tmesh.shard_batch(mesh, batch)
    assert [p["image"].shape[0] for p in parts] == [2, 2]
    np.testing.assert_array_equal(parts[1]["target"].numpy(), [2, 3])
    with pytest.raises(ValueError, match="do not divide"):
        tmesh.shard_batch(mesh, np.zeros((3, 1)))
    layer = torch.nn.Linear(2, 2)
    copies = tmesh.replicate(mesh, layer)
    assert copies[0] is layer and copies[1] is not layer
    assert torch.equal(copies[0].weight, copies[1].weight)
