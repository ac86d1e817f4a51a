"""tests/mp_workload.py for the port: the same widths and seeds, in torch
only, so the 2-process gloo workers (tests/mp_torch_worker.py) and the
single-process references of tests/test_torch_multiprocess.py run the SAME
functions, and a difference is the process boundary's."""

import numpy as np
import torch

from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn

NET_CONFIG = tfcn.FCNConfig(
    in_channels=3, down_filters=(4, 6, 8, 12, 16), mid_filters=16,
    upsample_filters=(4, 6, 8, 12, 16), up_filters=(4, 4, 6, 8, 12),
    pixel_features=(6, 4), kernel_size=3, pixel_kernel_size=3)

TRAIN_STEPS = 3
LEARNING_RATE = 0.1
# the three data-parallel cases: (use_weights, clip_norm)
TRAIN_CASES = {"plain": (False, None), "weighted": (True, None),
               "clipped": (True, 0.05)}


def make_train_batch(batch: int = 8, size: int = 32):
    """mp_workload.make_train_batch's arrays, plus per-pixel weights drawn
    after them from the same generator, whose sums differ between the two
    processes' halves."""
    rng = np.random.default_rng(7)
    out = {
        "image": rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32),
        "target": (rng.random((batch, size, size, 1)) > 0.6).astype(np.float32),
        "text_mask": (rng.random((batch, size, size, 1)) > 0.5).astype(np.float32),
    }
    weights = rng.uniform(0.0, 2.0, (batch, size, size, 1)).astype(np.float32)
    weights[:batch // 2] *= 0.25
    out["weights"] = weights
    return out


def make_frames(n: int = 8):
    from lecturemath_tpu_torch.utils.synthetic import synthetic_rgb_lecture

    rgb, _, _, _ = synthetic_rgb_lecture(seed=5, n_frames=n, height=64,
                                         width=96, glyphs_per_board=6,
                                         glyph_size=(12, 14))
    return rgb


def start_state_dict(config=NET_CONFIG, reconstruction_mode=False):
    """Seeded weights with the BatchNorm affines and running statistics
    moved off identity (so the running-stat updates show)."""
    model = tfcn.init_weights(tfcn.FCNLectureNet(config, reconstruction_mode),
                              torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.5, 1.5, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
                module.running_mean.normal_(0, 0.1, generator=gen)
                module.running_var.uniform_(0.5, 1.5, generator=gen)
    return model.state_dict()


def run_training(case: str, mesh=None):
    """TRAIN_STEPS SGD steps of the binarizer phase on the GLOBAL batch
    (a mesh's processes each keep their rows); returns (per-step totals,
    final state dict as numpy)."""
    from lecturemath_tpu_torch.train.trainer import Trainer

    use_weights, clip_norm = TRAIN_CASES[case]
    model = tfcn.FCNLectureNet(NET_CONFIG)
    model.load_state_dict(start_state_dict(), strict=True)
    trainer = Trainer(model, LEARNING_RATE, phase="binarizer",
                      use_weights=use_weights, clip_norm=clip_norm,
                      prefetch_depth=0, device="cpu", mesh=mesh)
    batch = make_train_batch()
    losses = [float(trainer.step(batch)["total"])
              for _ in range(TRAIN_STEPS)]
    state = {key: value.detach().numpy().copy()
             for key, value in trainer.model.state_dict().items()}
    return losses, state


def run_inference(frames, mesh=None, weights="threshold"):
    """The sharded Binarizer, full output (``binarize_frames``), over the
    threshold-head weights, or (``weights='start'``) the seeded start
    weights, whose logits read every layer; every process passes all
    frames."""
    from lecturemath_tpu_torch.pipeline.binarize import Binarizer
    from lecturemath_tpu_torch.utils.synthetic import \
        threshold_binarizer_variables

    model = tfcn.FCNLectureNet(NET_CONFIG)
    model.load_state_dict(start_state_dict() if weights == "start" else
                          threshold_binarizer_variables(NET_CONFIG))
    binarizer = Binarizer(model, batch_size=len(frames), mesh=mesh,
                          upload_format="rgb", device="cpu")
    return binarizer.binarize_frames(frames)


def bn_inputs(dtype=torch.float32):
    """A global (8, 5, 6, 7) input, the upstream gradient of the output,
    and a BatchNorm2d off identity; all from seeds."""
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(8, 5, 6, 7, generator=gen) * 2.0 + 0.5).to(dtype)
    upstream = torch.randn(8, 5, 6, 7, generator=gen).to(dtype)
    bn = torch.nn.BatchNorm2d(5)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.normal_(0, 0.1, generator=gen)
        bn.running_var.uniform_(0.5, 1.5, generator=gen)
    return x, upstream, bn


def run_batch_norm(dtype=torch.float32, rows=slice(None), group=None):
    """One training-mode step of the BatchNorm of ``bn_inputs`` on
    ``rows`` of the global input: torch's own over the whole batch
    (``group`` None), or the cross-replica one over ``group``. Returns the
    output, the input's gradient, the scale's and shift's gradients (a
    process's own part under ``group``) and the running buffers."""
    from lecturemath_tpu_torch.parallel.sync_norm import \
        cross_replica_batch_norm

    x, upstream, bn = bn_inputs(dtype)
    x = x[rows].clone().requires_grad_(True)
    y = bn(x) if group is None else cross_replica_batch_norm(bn, x, group)
    (y.float() * upstream[rows].float()).sum().backward()
    return {"y": y.detach().float().numpy(),
            "dx": x.grad.float().numpy(),
            "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


# the two uses of the mesh's model axis in ShardedBinarizer
MODEL_AXIS_FLAGS = ("shard_params_over_model", "shard_spatial")


def run_model_axis(frames, mesh, flag=None):
    """ShardedBinarizer over the seeded start weights (eval mode), with
    ``flag`` one of MODEL_AXIS_FLAGS (None: meshless, on a 1x1 CPU mesh):
    (binaries, thresholdless sigmoid * 255 maps), every frame."""
    from lecturemath_tpu_torch.parallel.inference import ShardedBinarizer
    from lecturemath_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    if mesh is None:
        mesh = make_mesh(MeshSpec(1, 1), [torch.device("cpu")])
    out = []
    for force_binary in (True, False):
        model = tfcn.FCNLectureNet(NET_CONFIG)
        model.load_state_dict(start_state_dict(), strict=True)
        kwargs = {flag: True} if flag else {}
        out.append(ShardedBinarizer(model.eval(), mesh,
                                    force_binary=force_binary,
                                    **kwargs).binarize_frames(frames))
    return out


def model_axis_logits(frames):
    """The meshless binarization logits of the start weights, cropped to
    the frames."""
    from lecturemath_tpu_torch.models.fcn_lecturenet import model_input

    model = tfcn.FCNLectureNet(NET_CONFIG)
    model.load_state_dict(start_state_dict(), strict=True)
    with torch.no_grad():
        x, (h, w) = model_input(torch.from_numpy(np.ascontiguousarray(
            frames)))
        return model.eval()(x)[0][:, 0, :h, :w].numpy()


# ------------------------------------------------------ model-axis training

# channel counts of which some divide by 2 and 4 and some do not: on 1x2 the
# transposed convs 5-3 are cut on their inputs and outputs, 2 on its
# outputs only, 1 on its inputs only; on 1x4 conv 5 on its inputs only, 4
# on both, 3 on its outputs only, 2 and 1 not at all; the 3-channel
# reconstruction and 1-channel logit heads are replicated on both, and on
# 1x4 the 6-channel layers too
AXIS_NET_CONFIG = tfcn.FCNConfig(
    in_channels=3, down_filters=(4, 6, 8, 12, 16), mid_filters=16,
    upsample_filters=(3, 6, 8, 8, 6), up_filters=(4, 6, 5, 6, 12),
    pixel_features=(6, 4), kernel_size=3, pixel_kernel_size=3)

# the model axis's training cases: Trainer options, and the phase
AXIS_TRAIN_CASES = {
    "live": dict(phase="binarizer"),
    "frozen": dict(phase="binarizer", freeze_bn=True),
    "folded": dict(phase="text_detector", freeze_bn=True,
                   fold_frozen_bn=True),
    "weighted": dict(phase="binarizer", use_weights=True),
    "clipped": dict(phase="binarizer", use_weights=True, clip_norm=0.05),
    "reconstruction": dict(phase="reconstruction"),
}
AXIS_MOMENTUM = 0.9


def axis_train_batch():
    """make_train_batch's arrays and a 3-channel median target (the
    reconstruction and text-detector phases' target)."""
    batch = make_train_batch()
    rng = np.random.default_rng(8)
    batch["median"] = rng.uniform(-1, 1, batch["image"].shape).astype(
        np.float32)
    return batch


def axis_trainer(case, mesh=None):
    """A Trainer of ``case`` over the seeded start weights of
    AXIS_NET_CONFIG, meshless on the CPU or on ``mesh``, and its batch."""
    from lecturemath_tpu_torch.train.trainer import Trainer

    options = dict(AXIS_TRAIN_CASES[case])
    rec = options["phase"] == "reconstruction"
    model = tfcn.FCNLectureNet(AXIS_NET_CONFIG, reconstruction_mode=rec)
    model.load_state_dict(start_state_dict(AXIS_NET_CONFIG, rec),
                          strict=True)
    trainer = Trainer(model, LEARNING_RATE, momentum=AXIS_MOMENTUM,
                      prefetch_depth=0, device="cpu", mesh=mesh, **options)
    batch = axis_train_batch()
    if rec:
        batch["target"] = batch["median"]
    return trainer, batch


def run_axis_training(case, mesh=None, steps=TRAIN_STEPS, checkpoint=None):
    """``steps`` SGD steps of ``case`` on the global batch; returns
    (per-step totals, the assembled final state as numpy). ``checkpoint``:
    a path ``Trainer.save`` writes the result to (process 0 of a world)."""
    trainer, batch = axis_trainer(case, mesh)
    losses = [float(trainer.step(batch)["total"]) for _ in range(steps)]
    if checkpoint is not None:
        trainer.save(checkpoint)
    state = {key: value.numpy().copy()
             for key, value in trainer.state_dict().items()}
    return losses, state
