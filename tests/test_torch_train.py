"""Repairs the training slice rests on, and the port's losses, fp32 on the
CPU at TINY widths:

  * kernel K2 (``conv_same_nhwc``) never sees a forward that carries
    gradients, and its cached packed head weights follow in-place updates;
  * ``.msgpack`` checkpoints both ways without the msgpack package: the
    port writes what the JAX package reads, byte for byte what flax writes,
    and reads what the JAX package writes;
  * ``phase_losses`` equals the JAX package's for every phase, with and
    without per-pixel weights.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.pipeline.binarize import (load_checkpoint_variables,
                                               save_checkpoint_variables)
from lecturemath_tpu.train.losses import phase_losses as jax_phase_losses
from lecturemath_tpu_torch.models import convert
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.ops import conv7
from lecturemath_tpu_torch.train.losses import phase_losses

torch.set_num_threads(1)

TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)


def _model(fold_bn=False, reconstruction_mode=False, seed=0):
    model = tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY), reconstruction_mode,
                               fold_bn=fold_bn)
    return tfcn.init_weights(model, torch.Generator().manual_seed(seed))


def _input(seed=0, shape=(2, 3, 32, 32)):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


# ------------------------------------------------------ K2 and gradients

@pytest.mark.parametrize("fold_bn", [False, True])
def test_k2_is_not_called_in_a_forward_with_grad(fold_bn, monkeypatch):
    """A grad-enabled forward runs the heads as F.conv2d over the concat
    (K2 has no backward); under torch.no_grad() all four heads go to
    conv_same_nhwc, as they do on the card."""
    calls = []

    def record(*args, **kwargs):
        calls.append(args[1].shape)
        return conv7.conv_same_plain(*args[:6])

    monkeypatch.setattr(tfcn, "conv_same_nhwc", record)
    model = _model(fold_bn).eval()
    logits, text, _ = model(_input())
    assert calls == []
    (logits.sum() + text.sum()).backward()
    for name in model.head_inputs():
        conv = getattr(model, name)[0]
        assert conv.weight.grad is not None
        assert conv.weight.grad.abs().sum() > 0, name
    with torch.no_grad():
        no_grad_logits, _, _ = model(_input())
    assert len(calls) == 4
    torch.testing.assert_close(no_grad_logits, logits.detach(), rtol=1e-5,
                               atol=1e-6)


def test_conv_same_nhwc_refuses_grad_off_the_cpu():
    """Off the CPU the wrapper raises before any launch when autograd would
    have to record the call (meta tensors stand in for the card's here)."""
    x = torch.zeros(1, 3, 8, 8, device="meta")
    weight = torch.zeros(2, 3, 3, 3, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        conv7.conv_same_nhwc(x, weight)
    assert conv7.needs_grad(x, None, weight)
    with torch.no_grad():
        assert not conv7.needs_grad(x, None, weight)
        with pytest.raises(ValueError, match="unsupported device"):
            conv7.conv_same_nhwc(x, weight)


@pytest.mark.parametrize("fold_bn", [False, True])
def test_head_packs_follow_in_place_updates(fold_bn):
    """head_pack keys each cache entry on the weight's and bias's
    data_ptr() and _version: an in-place update (what optimizer.step()
    does) repacks, an unchanged head keeps its pack."""
    model = _model(fold_bn)
    before = {name: model.head_pack(name) for name in model.head_inputs()}
    assert model.head_pack("conv_out")[0] is before["conv_out"][0]
    with torch.no_grad():
        model.conv_out[0].weight.add_(1)
        model.conv_pixels_1[0].bias.add_(1)
    packed, bias = model.head_pack("conv_out")
    assert packed is not before["conv_out"][0]
    expected = conv7.pack_weights(model.conv_out[0].weight,
                                  *model.head_inputs()["conv_out"],
                                  conv7.n_tiles(1))
    torch.testing.assert_close(packed, expected, rtol=0, atol=0)
    assert not torch.equal(packed, before["conv_out"][0])
    torch.testing.assert_close(model.head_pack("conv_pixels_1")[1],
                               model.conv_pixels_1[0].bias.float())
    assert model.head_pack("conv_pixels_2")[0] is \
        before["conv_pixels_2"][0]
    # an optimizer step on every parameter repacks every head
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    logits, text, _ = model(_input())
    (logits.mean() + text.mean()).backward()
    optimizer.step()
    for name in model.head_inputs():
        assert model.head_pack(name)[0] is not before[name][0], name


# ------------------------------------------------- msgpack without msgpack

@pytest.mark.parametrize("reconstruction_mode", [False, True])
def test_msgpack_written_by_the_port_loads_in_the_jax_package(
        reconstruction_mode, tmp_path, monkeypatch):
    model = _model(reconstruction_mode=reconstruction_mode, seed=3)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.running_mean.uniform_(-0.5, 0.5)
                module.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "port.msgpack")
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "msgpack", None)
        convert.save_checkpoint(model.state_dict(), path)
    variables = load_checkpoint_variables(path)
    # what flax itself writes for the same tree, byte for byte
    reference = str(tmp_path / "flax.msgpack")
    save_checkpoint_variables(variables, reference)
    assert open(path, "rb").read() == open(reference, "rb").read()
    back = convert.state_dict_from_flax(variables)
    expected = {k: v for k, v in model.state_dict().items()
                if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(model.state_dict())
    for key, value in expected.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0)
    # the JAX model runs on them: its forward equals the port's
    jmodel = jfcn.FCNLectureNet(jfcn.FCNConfig(**TINY),
                                reconstruction_mode=reconstruction_mode)
    x = _input(5)
    out = jmodel.apply(variables, jnp.asarray(x.permute(0, 2, 3, 1).numpy()))
    with torch.no_grad():
        ours = model.eval()(x)
    ours = ours if reconstruction_mode else ours[0]
    out = out if reconstruction_mode else out[0]
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(),
                               np.asarray(out), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reconstruction_mode", [False, True])
def test_msgpack_written_by_the_jax_package_loads_in_the_port(
        reconstruction_mode, tmp_path, monkeypatch):
    jmodel = jfcn.FCNLectureNet(jfcn.FCNConfig(**TINY),
                                reconstruction_mode=reconstruction_mode)
    variables = jax.tree.map(np.asarray, jfcn.init_variables(
        jmodel, jax.random.PRNGKey(reconstruction_mode)))
    path = str(tmp_path / "jax.msgpack")
    save_checkpoint_variables(variables, path)
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "msgpack", None)
        loaded = convert.load_checkpoint(path)
    expected = convert.state_dict_from_flax(variables)
    assert sorted(loaded) == sorted(expected)
    for key, value in expected.items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0)
    target = tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY), reconstruction_mode)
    target.load_state_dict(loaded, strict=True)


def test_msgpack_codec_covers_flax_leaves(tmp_path, monkeypatch):
    """Scalars (ext 3), bf16 arrays, ints of every width, floats, nil,
    bools, long strings and maps as flax's msgpack_serialize writes them."""
    import flax.serialization

    tree = {"a": np.float32(1.5), "b": np.arange(300, dtype=np.int64),
            "bf16": np.asarray(jnp.arange(5, dtype=jnp.bfloat16)),
            "c": np.zeros((), np.float32), "s": "x" * 40,
            "n": [1, -1, 200, -200, 70000, -70000, 2 ** 40, -2 ** 40, 1.5,
                  None, True, False],
            "m": {str(k): np.full((k, 2), k, np.float32) for k in range(20)}}
    path = tmp_path / "tree.msgpack"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    plain = {k: v for k, v in tree.items() if k != "bf16"}
    out = bytearray()
    with monkeypatch.context() as patch:
        patch.setitem(sys.modules, "msgpack", None)
        back = convert.load_msgpack_variables(str(path))
        convert._pack(out, convert._sorted_tree(plain))
    assert back["a"] == np.float32(1.5) and isinstance(back["a"], np.float32)
    np.testing.assert_array_equal(back["b"], tree["b"])
    np.testing.assert_array_equal(back["bf16"],
                                  np.arange(5, dtype=np.float32))
    assert back["c"].shape == () and back["s"] == tree["s"]
    assert back["n"] == tree["n"]
    for key, value in tree["m"].items():
        np.testing.assert_array_equal(back["m"][key], value)
    assert bytes(out) == flax.serialization.msgpack_serialize(plain)


# ------------------------------------------------------------- the losses

def _outputs(seed, phase):
    # small maps: the two packages sum their means in f32 in another
    # order, and the JAX CPU reduction drifts by about n * 2^-24 relative
    rng = np.random.default_rng(seed)
    b, h, w = 2, 8, 12
    bin_logits = rng.normal(0, 4, (b, h, w, 1)).astype(np.float32)
    text_logits = rng.normal(0, 4, (b, h, w, 1)).astype(np.float32)
    rec = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    batch = {"target": (rng.random((b, h, w, 1)) < 0.5).astype(np.float32),
             "text_mask": rng.random((b, h, w, 1)).astype(np.float32),
             "median": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
             "weights": rng.uniform(1, 3, (b, h, w, 1)).astype(np.float32)}
    if phase == "reconstruction":
        batch["target"] = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
        outputs = rec
    else:
        outputs = (bin_logits, text_logits, rec)
    return outputs, batch


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("use_weights", [False, True])
@pytest.mark.parametrize("phase", ["reconstruction", "text_detector",
                                   "binarizer"])
def test_phase_losses_equal_jax_package(phase, use_weights):
    for seed in range(6):
        outputs, batch = _outputs(seed, phase)
        if seed == 5:      # without the optional keys
            batch.pop("median")
            if phase == "binarizer":
                batch.pop("text_mask")
        theirs = jax_phase_losses(phase, jax.tree.map(jnp.asarray, outputs),
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()}, use_weights)
        t_outputs = (_nchw(outputs) if phase == "reconstruction"
                     else tuple(_nchw(o) for o in outputs))
        ours = phase_losses(phase, t_outputs,
                            {k: _nchw(v) for k, v in batch.items()},
                            use_weights)
        assert list(ours) == list(theirs)
        for key in theirs:
            assert ours[key].dtype == torch.float32
            np.testing.assert_allclose(float(ours[key]), float(theirs[key]),
                                       rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="unknown phase"):
        phase_losses("nope", (t_outputs,) * 3, {})
