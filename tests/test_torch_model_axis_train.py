"""Training over the mesh's model axis in one process, fp32 on the CPU at
tiny widths (``AXIS_NET_CONFIG`` of tests/_torch_mp_workload.py, whose
channel counts divide by 2 and 4 or not, so the transposed convs are cut
on their inputs, their outputs, both or neither, and replicated layers
occur):

- one SGD step on 1x2 and 1x4 against the meshless Trainer: every
  assembled gradient and new value within rtol 1e-5 / atol 1e-6, for live
  BN, frozen BN, frozen BN folded, weighted terms, the clip and the
  reconstruction phase;
- 3 steps against the JAX package's Trainer on MeshSpec(4, 2) and (2, 4)
  (the conftest's 8 virtual CPU devices): the losses and the assembled
  state within the same tolerance;
- a resume file written on 1x2 continues meshless and on 1x4 as the
  uninterrupted run;
- ``gather_params`` inverts ``shard_params`` and ``shard_state``, and
  ``fold_shards`` cuts the meshless fold as the shards hold it;
- in a torch.distributed world the Trainer refuses a process holding two
  cards.

The gloo worlds (1x2 across two processes, 2x2 a group in each) are
tests/test_torch_multiprocess.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from lecturemath_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lecturemath_tpu.train.trainer import Trainer as JaxTrainer
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import (
    flax_variables_from_state_dict, state_dict_from_flax)
from lecturemath_tpu_torch.parallel import mesh as tmesh
from lecturemath_tpu_torch.parallel.model_axis import fold_shards

import _torch_mp_workload as workload

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6


def cpu_mesh(model, data=1):
    return tmesh.make_mesh(tmesh.MeshSpec(data, model),
                           [CPU] * (data * model))


def assert_states_close(got, expected, what):
    assert sorted(got) == sorted(expected), what
    for key, value in expected.items():
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(value),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: {key}")


def one_step(case, mesh):
    """One step of ``case``: (loss, the assembled gradients, the assembled
    new state)."""
    trainer, batch = workload.axis_trainer(case, mesh)
    loss = float(trainer.step(batch)["total"])
    if mesh is None:
        grads = {name: p.grad.clone()
                 for name, p in trainer.model.named_parameters()}
    else:
        grads = tmesh.gather_params(mesh, trainer.shards, [
            {name: p.grad for name, p in shard.named_parameters()}
            for shard in trainer.shards])
    return loss, grads, trainer.state_dict()


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("case", list(workload.AXIS_TRAIN_CASES))
def test_one_step_equals_meshless(case, model):
    expected = one_step(case, None)
    got = one_step(case, cpu_mesh(model))
    np.testing.assert_allclose(got[0], expected[0], rtol=RTOL)
    assert_states_close(got[1], expected[1], "gradient")
    assert_states_close(got[2], expected[2], "state")
    start = workload.start_state_dict(workload.AXIS_NET_CONFIG,
                                      case == "reconstruction")
    # the step moved the weights, and a live BN its running statistics
    assert not np.array_equal(got[2]["mid_block.0.weight"],
                              start["mid_block.0.weight"])
    moved = not np.array_equal(got[2]["mid_block.1.running_var"],
                               start["mid_block.1.running_var"])
    assert moved == ("freeze_bn" not in workload.AXIS_TRAIN_CASES[case])


def test_the_cases_reach_every_cut():
    """The config's transposed convs are cut on their inputs, outputs,
    both or neither, and some layers are replicated, on 1x2 and 1x4."""
    state = workload.start_state_dict(workload.AXIS_NET_CONFIG)
    cuts = {}
    for model in (2, 4):
        specs = tmesh.params_pspec_tree(state, cpu_mesh(model))
        cuts[model] = [(bool(specs[f"transposed_conv_{i}.weight"]),
                        bool(specs[f"transposed_conv_{i}.bias"]))
                       for i in range(5, 0, -1)]
        assert not specs["conv_out.0.weight"]
        assert not specs["conv_reconstruct.0.weight"]
    assert cuts[2] == [(True, True)] * 3 + [(False, True), (True, False)]
    assert cuts[4] == [(True, False), (True, True), (False, True),
                       (False, False), (False, False)]


def _jax_config():
    c = workload.AXIS_NET_CONFIG
    return jfcn.FCNConfig(
        in_channels=c.in_channels, down_filters=c.down_filters,
        mid_filters=c.mid_filters, upsample_filters=c.upsample_filters,
        up_filters=c.up_filters, pixel_features=c.pixel_features,
        kernel_size=c.kernel_size, pixel_kernel_size=c.pixel_kernel_size)


def _jax_training(case, spec):
    """workload.TRAIN_STEPS steps of the JAX Trainer on a ``spec`` mesh
    from the same weights on the same batch: (losses, final state dict in
    the port's names)."""
    options = dict(workload.AXIS_TRAIN_CASES[case])
    variables = flax_variables_from_state_dict(
        workload.start_state_dict(workload.AXIS_NET_CONFIG))
    trainer = JaxTrainer(
        jfcn.FCNLectureNet(_jax_config(), dtype=jnp.float32),
        workload.LEARNING_RATE, momentum=workload.AXIS_MOMENTUM,
        mesh=jax_make_mesh(spec), **options)
    state = trainer.init_state(None, variables=jax.tree.map(jnp.asarray,
                                                            variables))
    assert "model" in state.params["mid"]["conv"]["kernel"].sharding.spec
    batch = workload.axis_train_batch()
    if not options.get("use_weights"):
        batch.pop("weights")
    losses = []
    for _ in range(workload.TRAIN_STEPS):
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["total"]))
    final = state_dict_from_flax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    # flax counts no BN batches
    return losses, {key: value.numpy() for key, value in final.items()
                    if not key.endswith("num_batches_tracked")}


@pytest.mark.parametrize("spec, model, case", [
    (JaxMeshSpec(4, 2), 2, "live"), (JaxMeshSpec(2, 4), 4, "clipped")])
def test_three_steps_equal_jax(spec, model, case):
    jax_losses, jax_state = _jax_training(case, spec)
    losses, state = workload.run_axis_training(case, cpu_mesh(model))
    assert jax_losses[-1] < jax_losses[0]
    np.testing.assert_allclose(losses, jax_losses, rtol=RTOL)
    assert_states_close({key: state[key] for key in jax_state}, jax_state,
                        f"{model}-way model axis vs JAX {spec}")


@pytest.mark.parametrize("target", [None, 4])
def test_resume_file_continues_on_any_mesh(tmp_path, target):
    """2 steps on 1x2 with momentum, the resume file written, then the
    third step meshless or on 1x4 from it: the uninterrupted meshless run's
    losses and state."""
    expected = workload.run_axis_training("weighted")
    first, batch = workload.axis_trainer("weighted", cpu_mesh(2))
    losses = [float(first.step(batch)["total"]) for _ in range(2)]
    path = str(tmp_path / "run.resume")
    first.save_resume_checkpoint(path)
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2
    assert sorted(saved["model"]) == sorted(expected[1])
    # the momentum buffers are the full model's, in its parameter order
    names = [name for name, _ in first.model.named_parameters()]
    assert saved["optimizer"]["param_groups"][0]["params"] == list(
        range(len(names)))
    for i, name in enumerate(names):
        assert saved["optimizer"]["state"][i]["momentum_buffer"].shape \
            == saved["model"][name].shape
    second, _ = workload.axis_trainer(
        "weighted", None if target is None else cpu_mesh(target))
    second.restore_resume_checkpoint(path)
    assert second.step_count == 2
    losses.append(float(second.step(batch)["total"]))
    np.testing.assert_allclose(losses, expected[0], rtol=RTOL)
    assert_states_close({key: value.numpy() for key, value in
                         second.state_dict().items()}, expected[1],
                        f"resumed on {target}")


@pytest.mark.parametrize("model", [2, 4])
def test_gather_params_inverts_shard_params(model):
    mesh = cpu_mesh(model)
    net = tfcn.FCNLectureNet(workload.AXIS_NET_CONFIG)
    full = workload.start_state_dict(workload.AXIS_NET_CONFIG)
    net.load_state_dict(full)
    shards = tmesh.shard_params(mesh, net)
    gathered = tmesh.gather_params(mesh, shards)
    assert sorted(gathered) == sorted(full)
    for key, value in full.items():
        assert torch.equal(gathered[key], value), key
    for shard, part in zip(shards, tmesh.shard_state(mesh, full)):
        own = shard.state_dict()
        assert sorted(own) == sorted(part)
        for key, value in part.items():
            assert torch.equal(own[key], value), key


@pytest.mark.parametrize("model", [2, 4])
def test_fold_shards_cuts_the_meshless_fold(model):
    """Each shard's fold is the meshless fold cut as ``shard_params`` cuts
    the fold_bn model's tensors (the transposed convs' weights scaled by
    the gathered BN scale), and gradients reach every shard's BN."""
    mesh = cpu_mesh(model)
    net = tfcn.FCNLectureNet(workload.AXIS_NET_CONFIG)
    net.load_state_dict(workload.start_state_dict(workload.AXIS_NET_CONFIG))
    expected = tfcn.fold_batch_norms(net.state_dict())
    shards = tmesh.shard_params(mesh, net)
    folds = fold_shards(shards)
    specs = shards[0].model_specs
    for index, fold in enumerate(folds):
        assert sorted(fold) == sorted(expected)
        for key, value in expected.items():
            if specs[key]:
                size = value.shape[0] // model
                value = value[index * size:(index + 1) * size]
            torch.testing.assert_close(fold[key], value, rtol=1e-6,
                                       atol=1e-7, msg=key)
    sum(value.sum() for fold in folds for value in fold.values()).backward()
    for shard in shards:
        assert shard.upsample_block_5[0].weight.grad.abs().sum() > 0


def test_a_world_process_holds_one_card():
    """In a torch.distributed world a training process holds one card:
    autograd runs one thread a card, so a backward's collectives on two
    cards could meet their peers in another order. The Trainer refuses two
    cards of a 1x2 mesh there (before touching a card), and takes two CPU
    shards."""
    import torch.distributed as dist

    from lecturemath_tpu_torch.parallel.launch import free_port
    from lecturemath_tpu_torch.train.trainer import Trainer

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        cards = tmesh.make_mesh(tmesh.MeshSpec(1, 2),
                                [torch.device("cuda", k) for k in range(2)])
        with pytest.raises(ValueError, match="trains on one card"):
            Trainer(tfcn.FCNLectureNet(workload.AXIS_NET_CONFIG), 0.1,
                    mesh=cards)
        trainer = Trainer(tfcn.FCNLectureNet(workload.AXIS_NET_CONFIG), 0.1,
                          mesh=cpu_mesh(2))
        assert trainer._group is dist.group.WORLD
        assert [s.bn_group for s in trainer.shards] == [dist.group.WORLD] * 2
    finally:
        dist.destroy_process_group()
