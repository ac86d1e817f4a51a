"""Parity of the port's FCN-LectureNet and stage-01 helpers
(lecturemath_tpu_torch.models) with the JAX package, fp32 on the CPU at TINY
widths. Inputs come from numpy seeds and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.pipeline.binarize import save_checkpoint_variables
from lecturemath_tpu.utils.synthetic import (
    threshold_binarizer_variables as jax_threshold_variables)
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import (load_checkpoint,
                                                  state_dict_from_flax)
from lecturemath_tpu_torch.utils.synthetic import threshold_binarizer_variables

torch.set_num_threads(1)

# tests/test_model.py's TINY widths; the second config runs the k=7 heads
TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)
TINY_K7 = dict(TINY, pixel_kernel_size=7)

# fp32 forward of two implementations of the same graph: only the summation
# order differs, ~1e-6 relative on logits of magnitude <= 10
LOGIT_ATOL = 1e-5


def _randomize_batch_stats(tree, rng):
    for key, value in tree.items():
        if isinstance(value, dict):
            _randomize_batch_stats(value, rng)
        elif key == "mean":
            tree[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        elif key == "var":
            tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)


def _make_pair(cfg):
    """(JAX model, its variables, port model with the same weights)."""
    jmodel = jfcn.FCNLectureNet(jfcn.FCNConfig(**cfg))
    variables = jax.tree.map(np.asarray, jfcn.init_variables(
        jmodel, jax.random.PRNGKey(0), (1, 64, 64, 3)))
    _randomize_batch_stats(variables["batch_stats"],
                           np.random.default_rng(0))
    tmodel = tfcn.FCNLectureNet(tfcn.FCNConfig(**cfg))
    tmodel.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def pair():
    return _make_pair(TINY)


@pytest.fixture(scope="module")
def pair_k7():
    return _make_pair(TINY_K7)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _input(seed=0, shape=(2, 64, 96, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_state_dict_from_flax_loads_strict(pair):
    _, variables, tmodel = pair
    sd = state_dict_from_flax(variables)
    expected = tmodel.state_dict()
    assert sorted(sd) == sorted(expected)
    for key, value in expected.items():
        assert tuple(sd[key].shape) == tuple(value.shape), key


def test_msgpack_checkpoint_loads_without_flax(pair, tmp_path):
    _, variables, _ = pair
    path = str(tmp_path / "tiny.msgpack")
    save_checkpoint_variables(variables, path)
    loaded = load_checkpoint(path)
    expected = state_dict_from_flax(variables)
    assert sorted(loaded) == sorted(expected)
    for key in expected:
        torch.testing.assert_close(loaded[key], expected[key], rtol=0, atol=0)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("pk", [3, 7])
def test_forward_logits_match(pair, pair_k7, folded, pk):
    jmodel, variables, tmodel = pair if pk == 3 else pair_k7
    x = _input()
    if folded:
        jmodel = jfcn.FCNLectureNet(jmodel.config, fold_bn=True)
        variables = jfcn.fold_batch_norms(variables)
        tmodel = tfcn.fold_model(tmodel).eval()
    jout = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tout = tmodel(_nchw(x))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(_nhwc(t), np.asarray(j), atol=LOGIT_ATOL)


@pytest.mark.parametrize("mode", ["diff", "encode"])
def test_forward_modes_match(pair, mode):
    jmodel, variables, tmodel = pair
    x = _input(1)
    jout = jax.jit(lambda v, a: jmodel.apply(v, a, train=False, mode=mode))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        tout = tmodel(_nchw(x), mode=mode)
    if mode == "encode":
        jout, tout = (jout,), (tout,)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(_nhwc(t), np.asarray(j), atol=LOGIT_ATOL)


def test_reconstruction_mode_matches(pair):
    jmodel, variables, _ = pair
    cfg = jmodel.config
    jrec_model = jfcn.FCNLectureNet(cfg, reconstruction_mode=True)
    rec_sd = {k: v for k, v in state_dict_from_flax(variables).items()
              if not k.startswith(("conv_text", "conv_pixels", "conv_out"))}
    tmodel = tfcn.FCNLectureNet(tfcn.FCNConfig(**vars(cfg)),
                                reconstruction_mode=True)
    tmodel.load_state_dict(rec_sd, strict=True)
    x = _input(2, (1, 32, 64, 3))
    jrec = jax.jit(lambda v, a: jrec_model.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        trec = tmodel.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(trec), np.asarray(jrec), atol=LOGIT_ATOL)


@pytest.mark.parametrize("source", ["converted", "port_seed"])
@pytest.mark.parametrize("input_format", ["rgb", "yuv420"])
def test_packed_bits_equal_with_threshold_weights(pair, source,
                                                  input_format):
    """Bit-identical packed output: the JAX package's threshold weights
    converted, and the port's own numpy-seeded threshold weights (same heads,
    another random trunk the heads ignore)."""
    jmodel, _, _ = pair
    cfg = jmodel.config
    jvars = jax_threshold_variables(cfg)
    jfn = jfcn.make_packed_binarizer(
        jfcn.FCNLectureNet(cfg, fold_bn=True), jfcn.fold_batch_norms(jvars),
        input_format=input_format)
    sd = (state_dict_from_flax(jvars) if source == "converted"
          else threshold_binarizer_variables(tfcn.FCNConfig(**vars(cfg)),
                                             seed=5))
    tmodel = tfcn.FCNLectureNet(tfcn.FCNConfig(**vars(cfg)))
    tmodel.load_state_dict(sd, strict=True)
    tfn = tfcn.make_packed_binarizer(tfcn.fold_model(tmodel).eval(),
                                     input_format=input_format)

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (3, 52, 70, 3), dtype=np.uint8)
    frames = (jfcn.rgb_to_yuv420_host(rgb) if input_format == "yuv420"
              else rgb)
    jbits = np.asarray(jfn(jnp.asarray(frames)))
    tbits = tfn(torch.from_numpy(frames)).numpy()
    assert tbits.shape == (3, 52, 9)
    np.testing.assert_array_equal(tbits, jbits)


@pytest.mark.parametrize("seed", range(5))
def test_yuv420_to_rgb_equal(seed):
    """The tests/test_stage01.py fuzz geometries and content styles."""
    rng = np.random.default_rng(700 + seed)
    height = int(rng.integers(4, 60)) * 4
    width = int(rng.integers(4, 80)) * 2
    if seed % 2:
        rgb = np.clip(rng.normal(220, 10, (2, height, width, 3)), 0,
                      255).astype(np.uint8)
        rgb[:, height // 4:height // 2, width // 4:width // 2] = 30
    else:
        rgb = rng.integers(0, 256, (2, height, width, 3), np.uint8)
    planes = jfcn.rgb_to_yuv420_host(rgb)
    ours = tfcn.yuv420_to_rgb(torch.from_numpy(planes)).numpy()
    theirs = np.asarray(jfcn.yuv420_to_rgb(jnp.asarray(planes)))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("shape,halvings", [((2, 37, 51, 3), 1),
                                            ((1, 64, 90, 3), 2)])
def test_device_halve_equal(shape, halvings):
    rgb = np.random.default_rng(9).integers(0, 256, shape, dtype=np.uint8)
    ours = tfcn.device_halve(torch.from_numpy(rgb), halvings).numpy()
    theirs = np.asarray(jfcn.device_halve(jnp.asarray(rgb), halvings))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("shape", [(1, 30, 45, 3), (2, 33, 64, 3),
                                   (1, 64, 31, 3)])
def test_prepare_and_pad_equal(shape):
    rgb = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    ours, ours_hw = tfcn.pad_to_multiple(
        tfcn.prepare_images(torch.from_numpy(rgb)))
    theirs, theirs_hw = jfcn.pad_to_multiple(
        jfcn.prepare_images(jnp.asarray(rgb)))
    assert ours_hw == theirs_hw
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("width", [1, 7, 8, 13, 64, 127])
def test_pack_bits_equal(width):
    binary = np.random.default_rng(width).integers(0, 2, (2, 5, width))
    ours = tfcn.pack_bits(torch.from_numpy(binary * 255)).numpy()
    theirs = np.asarray(jfcn.pack_bits(jnp.asarray(binary * 255)))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        tfcn.unpack_bits_host(ours, width), (binary * 255).astype(np.uint8))


@pytest.mark.parametrize("folded", [False, True])
def test_cached_head_packs_follow_the_weights(folded):
    """K2's packed weights are cached per head (``head_pack``) and are
    ``pack_weights`` of the CURRENT weights: after load_state_dict (an
    in-place copy) and after .to (new tensors); a repeat call returns the
    same cached tensors."""
    from lecturemath_tpu_torch.ops.conv7 import n_tiles, pack_weights

    cfg = tfcn.FCNConfig(**TINY_K7)
    model = tfcn.FCNLectureNet(cfg, fold_bn=folded)
    rng = np.random.default_rng(11)

    def randomize():
        model.load_state_dict({
            key: torch.from_numpy(rng.normal(0, 1, tuple(value.shape)).astype(
                np.float32)) if value.is_floating_point() else value
            for key, value in model.state_dict().items()})

    def check():
        for name, (c1, c2) in model.head_inputs().items():
            conv = getattr(model, name)[0]
            packed, bias = model.head_pack(name)
            expected = pack_weights(conv.weight, c1, c2,
                                    n_tiles(conv.weight.shape[0]))
            assert packed.dtype == torch.bfloat16
            assert torch.equal(packed, expected), name
            assert torch.equal(bias, conv.bias.float()), name

    randomize()
    model.pack_heads()
    check()
    first = model.head_pack("conv_out")
    assert model.head_pack("conv_out")[0] is first[0]   # cached
    randomize()                                         # in-place copies
    check()
    assert model.head_pack("conv_out")[0] is not first[0]
    model.pack_heads()
    model = model.to(torch.bfloat16)                    # new tensors
    check()
