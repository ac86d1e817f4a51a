"""Step parity of the port's Trainer with the JAX package's: three SGD
steps from identical weights on the same batches, every parameter and
running buffer and every loss term held to the JAX Trainer's, fp32 on the
CPU at TINY widths. The binarizer phase here; the pretraining phases in
tests/test_torch_train_phases.py."""

import numpy as np
import pytest
import torch

from _torch_train_parity import check_three_steps

torch.set_num_threads(1)


@pytest.mark.parametrize("jax_s2d", [False, True], ids=["plain", "jax_s2d"])
def test_binarizer_live_bn(jax_s2d):
    """Live BN (running stats updated each step); the JAX package's
    space-to-depth training layout gives the same trajectory as its plain
    one, and the port has one layout."""
    check_three_steps("binarizer", jax_s2d=jax_s2d)


def test_binarizer_frozen_bn_with_fold():
    trainer = check_three_steps("binarizer", freeze_bn=True, fold=True)
    for module in trainer.model.modules():
        if isinstance(module, torch.nn.BatchNorm2d):
            assert int(module.num_batches_tracked) == 0


def test_binarizer_clip_norm_momentum_and_weights():
    """optax's clip_by_global_norm (the norm here is well above 0.05),
    momentum (optax's trace is torch's buffer) and weighted losses."""
    check_three_steps("binarizer", clip_norm=0.05, momentum=0.9,
                      use_weights=True)


def test_clip_by_global_norm_is_optax_formula():
    from lecturemath_tpu_torch.train.trainer import clip_by_global_norm_

    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    grads = [rng.normal(0, 1, s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        clip_by_global_norm_(params, max_norm)
        updates, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        for p, u in zip(params, updates):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(u),
                                       rtol=1e-6)



@pytest.mark.parametrize("before", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("phase", ["reconstruction", "binarizer"])
def test_step_times_convolutions_and_restores_the_flag(phase, before):
    """The reconstruction phase's forward and backward run with cuDNN's
    engine timing on, the binarizer's with the flag as the caller set it;
    the step leaves ``torch.backends.cudnn.benchmark`` as it found it."""
    from _torch_train_parity import TINY, batch
    from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
    from lecturemath_tpu_torch.train.trainer import Trainer

    model = tfcn.init_weights(
        tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY),
                           phase == "reconstruction"),
        torch.Generator().manual_seed(0))
    seen = []
    model.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.benchmark))
    trainer = Trainer(model, 0.05, phase=phase, prefetch_depth=0,
                      device="cpu")
    kept = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = before
    try:
        trainer.step(batch(0))
        assert seen == [phase == "reconstruction" or before]
        assert torch.backends.cudnn.benchmark is before
    finally:
        torch.backends.cudnn.benchmark = kept
