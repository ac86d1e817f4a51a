"""The mesh's model axis for inference in the port (parallel/model_axis.py)
against the JAX package's, on the CPU in one process.

- ``params_pspec_tree`` equals the JAX package's key by key (through
  ``convert.state_dict_specs_from_flax``) at production widths, M in
  {2, 3, 4, 8}; ``shard_params``' slices reassemble the state dict.
- The channel path and the height path give the meshless logits within
  ATOL: channel slices and slab heights change the convs' blocking, and the
  transposed convs' sum over input-channel shards changes the summation
  order. That includes widths that leave some layers replicated and a
  height (64 over M = 4) that leaves shards with no rows.
- ``ShardedBinarizer`` (channels on 2x2 and 1x4 meshes, height at M = 3
  and 4 and heights 64 and 40) gives the port's meshless binaries and the
  JAX package's ``ShardedBinarizer`` output on its virtual 8-device mesh.
  Binaries must be equal except at pixels whose meshless logit lies within
  NEAR of the threshold's logit; those are counted and bounded (at most
  MAX_NEAR of the pixels). Full-output maps (sigmoid * 255 truncated) may
  differ by one level, at such pixels only.
- The stage-01 ``Binarizer`` on a 2x2 mesh streams the meshless frames.

fp32, seeded weights with the BatchNorms moved off identity (xavier-normal
heads, so the binarization logits depend on every layer), frames of a
seeded synthetic lecture.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.parallel import mesh as jmesh
from lecturemath_tpu.parallel.inference import \
    ShardedBinarizer as JaxShardedBinarizer
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import (
    flax_variables_from_state_dict, state_dict_specs_from_flax)
from lecturemath_tpu_torch.parallel import mesh as tmesh
from lecturemath_tpu_torch.parallel.inference import ShardedBinarizer
from lecturemath_tpu_torch.parallel.model_axis import (
    forward_channel_sharded, forward_height_sharded, packed_height_sharded,
    slab_rows)
from lecturemath_tpu_torch.pipeline import binarize as port_binarize
from lecturemath_tpu_torch.pipeline.binarize import Binarizer
from lecturemath_tpu_torch.pipeline.video import ArraySource
from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_parallel.py's widths: every layer shards at M = 2, 4 and 8
SHARDY = dict(down_filters=(8, 8, 16, 16, 16), mid_filters=16,
              upsample_filters=(8, 8, 8, 16, 16),
              up_filters=(8, 8, 8, 16, 16), pixel_features=(8, 8),
              kernel_size=3, pixel_kernel_size=3)
# widths that leave some layers replicated at M = 2, 3 and 4, and
# transposed convs whose input shards while the output does not (and the
# other way round)
MIXED = dict(down_filters=(6, 8, 12, 9, 16), mid_filters=12,
             upsample_filters=(4, 6, 9, 8, 12),
             up_filters=(6, 4, 6, 12, 8), pixel_features=(6, 4),
             kernel_size=3, pixel_kernel_size=5)
# sharded against meshless logits, fp32
ATOL = 1e-5
# the logit at which sigmoid * 255 truncated reaches the threshold 128
THRESHOLD_LOGIT = math.log(128 / 127)
# pixels closer than NEAR to it may binarize either way (the JAX package
# sums in yet another order than the port); at most MAX_NEAR of them
NEAR = 1e-5
MAX_NEAR = 1e-3


def _model(widths, seed=0):
    """Seeded xavier-normal weights, BatchNorms off identity, eval mode."""
    model = tfcn.init_weights(tfcn.FCNLectureNet(tfcn.FCNConfig(**widths)),
                              torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.5, 1.5, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
                module.running_mean.normal_(0, 0.1, generator=gen)
                module.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.eval()


def _copy(model):
    fresh = tfcn.FCNLectureNet(model.config)
    fresh.load_state_dict(model.state_dict(), strict=True)
    return fresh.eval()


def _frames(n=8, height=64, width=96, seed=2):
    rgb, _, _, _ = synthetic_rgb_lecture(seed=seed, n_frames=n,
                                         height=height, width=width,
                                         glyphs_per_board=4,
                                         glyph_size=(12, 14))
    return rgb


def _mesh(data, model):
    return tmesh.make_mesh(tmesh.MeshSpec(data, model), [CPU] * (data * model))


def _input(frames):
    x, _ = tfcn.model_input(torch.from_numpy(np.ascontiguousarray(frames)))
    return x


def _near(model, frames):
    """Pixels whose meshless binarization logit lies within NEAR of the
    threshold's, over the frames' crop; asserts they are few."""
    with torch.no_grad():
        logits = model(_input(frames))[0][:, 0].numpy()
    near = np.abs(logits - THRESHOLD_LOGIT) < NEAR
    near = near[:, :frames.shape[1], :frames.shape[2]]
    assert near.mean() <= MAX_NEAR, near.mean()
    return near


def _assert_binaries(got, expected, near):
    differ = got != expected
    assert not (differ & ~near).any(), int((differ & ~near).sum())


def _jax(model, mesh_shape, **kwargs):
    cfg = jfcn.FCNConfig(**{key: getattr(model.config, key)
                            for key in SHARDY})
    variables = flax_variables_from_state_dict(model.state_dict())
    mesh = jmesh.make_mesh(jmesh.MeshSpec(*mesh_shape),
                           devices=jax.devices()[:math.prod(mesh_shape)])
    return JaxShardedBinarizer(jfcn.FCNLectureNet(cfg, dtype=jnp.float32),
                               jax.tree.map(jnp.asarray, variables), mesh,
                               **kwargs)


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("model_size", [2, 3, 4, 8])
def test_pspec_tree_matches_jax(model_size):
    """Production widths 48..768: the port's spec of every state_dict key
    is the JAX package's, through the convert.py mapping; the running
    statistics follow their BatchNorm's channels."""
    cfg = jfcn.FCNConfig()
    shapes = jax.eval_shape(lambda: jfcn.init_variables(
        jfcn.FCNLectureNet(cfg), jax.random.PRNGKey(0)))
    jax_mesh = jmesh.make_mesh(jmesh.MeshSpec(1, model_size),
                               devices=jax.devices()[:model_size])
    theirs = state_dict_specs_from_flax(
        jmesh.params_pspec_tree(shapes["params"], jax_mesh))
    with torch.device("meta"):
        state = tfcn.FCNLectureNet(tfcn.FCNConfig()).state_dict()
    ours = tmesh.params_pspec_tree(state, _mesh(1, model_size))
    assert set(theirs) < set(ours)
    for key, spec in ours.items():
        if key in theirs:
            assert spec == theirs[key], key
        elif key.endswith(("running_mean", "running_var")):
            assert spec == ours[key.rsplit(".", 1)[0] + ".weight"], key
        else:
            assert key.endswith("num_batches_tracked") and spec == (), key
    sharded = sum(bool(spec) for spec in ours.values())
    assert sharded > len(ours) // 2
    if model_size == 2:
        # transposed convs: flax kernel (kh, kw, O, I) shards I, which is
        # torch axis 0 of (I, O, kh, kw); their biases shard O
        for level in range(1, 6):
            assert ours[f"transposed_conv_{level}.weight"] == (
                "model", None, None, None)
            assert ours[f"transposed_conv_{level}.bias"] == ("model",)
        assert state["transposed_conv_5.weight"].shape[0] == 768
        for head in ("conv_out", "conv_text_mask_out", "conv_reconstruct"):
            assert ours[f"{head}.0.weight"] == () and \
                ours[f"{head}.0.bias"] == (), head
    if model_size == 3:
        # the reconstruction head's 3 channels shard at M = 3
        assert ours["conv_reconstruct.0.weight"] == ("model", None, None,
                                                     None)


@pytest.mark.parametrize("widths,model_size", [(SHARDY, 2), (MIXED, 3),
                                               (MIXED, 4)])
def test_shard_params_reassemble(widths, model_size):
    model = _model(widths)
    mesh = _mesh(1, model_size)
    shards = tmesh.shard_params(mesh, model)
    specs = tmesh.params_pspec_tree(model.state_dict(), mesh)
    assert [s.model_index for s in shards] == list(range(model_size))
    pieces = [s.state_dict() for s in shards]
    for key, value in model.state_dict().items():
        if specs[key]:
            got = torch.cat([p[key] for p in pieces])
        else:
            assert all(torch.equal(p[key], pieces[0][key]) for p in pieces)
            got = pieces[0][key]
        assert torch.equal(got, value), key
    # the shards own their slices; the model keeps its weights
    assert shards[0].mid_block[0].weight.data_ptr() != \
        model.mid_block[0].weight.data_ptr()


# ----------------------------------------------------- the two networks

@pytest.mark.parametrize("widths,model_size,height", [
    (SHARDY, 2, 64), (SHARDY, 4, 64), (MIXED, 3, 96), (MIXED, 4, 64)])
def test_sharded_logits_match_meshless(widths, model_size, height):
    """Both paths against the meshless forward: the three outputs within
    ATOL. Height 64 over M = 4 is two 32-row units: two shards hold no
    rows; 96 over 3 is one unit each."""
    model = _model(widths)
    x = _input(_frames(n=2, height=height))
    mesh = _mesh(1, model_size)
    with torch.no_grad():
        expected = model(x)
        channel = forward_channel_sharded(tmesh.shard_params(mesh, model), x)
        spatial = forward_height_sharded(tmesh.replicate(mesh, _copy(model)),
                                         x)
    for got in (channel, spatial):
        for a, b in zip(got, expected):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=ATOL)
    rows = slab_rows(height, model_size)
    assert sum(rows) == height and all(r % 32 == 0 for r in rows)
    if (height, model_size) == (64, 4):
        assert rows == [32, 32, 0, 0]


def test_packed_height_sharded_crops_each_slab():
    """K1's plain version on each slab, cropped to a height that ends
    inside the second slab, gathered: the meshless packed bitmap."""
    model = _model(SHARDY)
    frames = _frames(n=2, height=40)
    x = _input(frames)
    with torch.no_grad():
        got = packed_height_sharded(
            tmesh.replicate(_mesh(1, 4), _copy(model)), x, 40, 96)
        expected = tfcn.make_packed_binarizer(model)(
            torch.from_numpy(frames))
    assert got.shape == (2, 40, 12)
    near = _near(model, frames)
    _assert_binaries(tfcn.unpack_bits_host(got.numpy(), 96),
                     tfcn.unpack_bits_host(expected.numpy(), 96), near)


# ------------------------------------------------------ ShardedBinarizer

@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
def test_channel_sharded_binarizer_matches_jax(mesh_shape):
    model = _model(SHARDY)
    frames = _frames()
    near = _near(model, frames)
    ours = ShardedBinarizer(_copy(model), _mesh(*mesh_shape),
                            shard_params_over_model=True)
    assert len(ours.shards) == 4 and ours.shards[1].model_index == 1
    got = ours.binarize_frames(frames)
    assert got.shape == (8, 64, 96)
    meshless = ShardedBinarizer(_copy(model), _mesh(1, 1))
    _assert_binaries(got, meshless.binarize_frames(frames), near)
    theirs = _jax(model, (4, 2), shard_params_over_model=True)
    _assert_binaries(got, theirs.binarize_frames(frames), near)
    # a ragged batch pads internally and crops back
    np.testing.assert_array_equal(ours.binarize_frames(frames[:5]), got[:5])


@pytest.mark.parametrize("height", [64, 40])
@pytest.mark.parametrize("model_size", [4, 3])
def test_height_sharded_binarizer_matches_jax(height, model_size):
    """tests/test_parallel.py's case (heights 64 and 40 over M = 4, where
    two shards hold no rows) and M = 3, whose lcm(32, 3) = 96-row padding
    the meshless port is given by hand."""
    model = _model(SHARDY)
    frames = _frames(n=4, height=height, width=48)
    ours = ShardedBinarizer(_copy(model), _mesh(2, model_size),
                            shard_spatial=True)
    got = ours.binarize_frames(frames)
    assert got.shape == (4, height, 48)
    unit = int(np.lcm(32, model_size))
    padded = np.pad(frames, ((0, 0), (0, (-height) % unit), (0, 0), (0, 0)),
                    mode="edge")
    near = _near(model, padded)[:, :height]
    meshless = ShardedBinarizer(_copy(model), _mesh(1, 1))
    _assert_binaries(got, meshless.binarize_frames(padded)[:, :height],
                     near)
    theirs = _jax(model, (2, model_size), shard_spatial=True)
    _assert_binaries(got, theirs.binarize_frames(frames), near)


def test_both_uses_of_the_model_axis_raise():
    model = _model(SHARDY)
    with pytest.raises(ValueError, match="pick one"):
        ShardedBinarizer(model, _mesh(1, 2), shard_params_over_model=True,
                         shard_spatial=True)


@pytest.mark.parametrize("flag", ["shard_params_over_model",
                                  "shard_spatial"])
def test_full_output_on_the_model_axis(flag):
    """force_binary=False: the sigmoid * 255 map, within one level of the
    meshless one, and that only at pixels near the threshold's logit
    (here: any logit within NEAR of a level boundary)."""
    model = _model(MIXED)
    frames = _frames(n=2)
    ours = ShardedBinarizer(_copy(model), _mesh(1, 2), force_binary=False,
                            **{flag: True})
    got = ours.binarize_frames(frames).astype(int)
    expected = ShardedBinarizer(_copy(model), _mesh(1, 1),
                                force_binary=False).binarize_frames(
        frames).astype(int)
    assert not np.isin(got, (0, 255)).all()
    assert np.abs(got - expected).max() <= 1
    assert np.mean(got != expected) <= MAX_NEAR


def test_model_axis_without_a_flag_replicates():
    """Neither flag: the model axis holds replicas, as the JAX package's
    replicated params over 'model' do; each data position's first one
    runs."""
    model = _model(SHARDY)
    frames = _frames(n=4)
    ours = ShardedBinarizer(_copy(model), _mesh(2, 2)).binarize_frames(
        frames)
    np.testing.assert_array_equal(
        ours, ShardedBinarizer(_copy(model), _mesh(1, 1)).binarize_frames(
            frames))


# ------------------------------------------------------------- stage 01

@pytest.mark.parametrize("async_drain", [True, False])
def test_binarizer_on_a_2x2_mesh_streams_the_meshless_frames(async_drain,
                                                            monkeypatch):
    """11 frames in batches of 4: BN folded, then channel-sharded over each
    data position's 2 devices; the batch rounds to the data axis only."""
    model = _model(MIXED)
    frames = _frames(n=11)
    kwargs = dict(upload_format="rgb")
    if not async_drain:
        # the stream drains inline in a world of more than one process
        monkeypatch.setattr(port_binarize, "process_count", lambda: 2)
    meshed = Binarizer(_copy(model), batch_size=3, mesh=_mesh(2, 2),
                       **kwargs)
    assert meshed.batch_size == 4 and len(meshed._replicas) == 4
    assert meshed._replicas[3].model_index == 1
    assert meshed._replicas[0].fold_bn
    assert len(meshed.packed_fns) == 2     # one a data position
    meshless = Binarizer(_copy(model), batch_size=4, device="cpu", **kwargs)
    ours = meshed.process_source(ArraySource(frames, fps=1.0))
    plain = meshless.process_source(ArraySource(frames, fps=1.0))
    assert ours[0] == plain[0] and ours[1] == plain[1] == list(range(11))
    folded = tfcn.fold_model(_copy(model)).eval()
    near = _near(folded, frames)
    # the stream's frames are inverted (ink = 255)
    _assert_binaries(np.stack(ours[2]), np.stack(plain[2]), near)
    _assert_binaries(meshed.binarize_frames(frames[:5]),
                     meshless.binarize_frames(frames[:5]), near[:5])
