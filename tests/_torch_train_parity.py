"""Shared by tests/test_torch_train_steps.py and
tests/test_torch_train_phases.py: three SGD steps from identical weights
through the JAX package's Trainer and the port's, fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lecturemath_tpu.models import fcn_lecturenet as jfcn
from lecturemath_tpu.train.trainer import Trainer as JAXTrainer
from lecturemath_tpu_torch.models import fcn_lecturenet as tfcn
from lecturemath_tpu_torch.models.convert import (
    flax_variables_from_state_dict, state_dict_from_flax)
from lecturemath_tpu_torch.train.trainer import Trainer

TINY = dict(down_filters=(2, 3, 4, 5, 6), mid_filters=6,
            upsample_filters=(2, 3, 4, 5, 6), up_filters=(2, 3, 4, 5, 6),
            pixel_features=(4, 3), kernel_size=3, pixel_kernel_size=3)
# a step-parity bound of rtol 1e-4 / atol 1e-5 for the weights and rtol
# 1e-5 for the losses holds ten times tighter in fp32
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
LOSS_RTOL = 2e-6


def batch(seed=0, shape=(2, 32, 32)):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    return {"image": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "target": (rng.random((b, h, w, 1)) < 0.5).astype(np.float32),
            "text_mask": (rng.random((b, h, w, 1)) < 0.4).astype(np.float32),
            "median": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32),
            "weights": rng.uniform(1, 2, (b, h, w, 1)).astype(np.float32)}


def start_weights(reconstruction_mode, seed=0):
    """A port model's seeded weights with BN affines and running stats
    moved off identity, as the JAX package's variables and carried back
    into the port by ``state_dict_from_flax``."""
    model = tfcn.init_weights(
        tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY), reconstruction_mode),
        torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.BatchNorm2d):
                module.weight.uniform_(0.5, 1.5, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
                module.running_mean.normal_(0, 0.1, generator=gen)
                module.running_var.uniform_(0.5, 1.5, generator=gen)
    return flax_variables_from_state_dict(model.state_dict())


def check_three_steps(phase, freeze_bn=False, fold=False, clip_norm=None,
                      use_weights=False, jax_s2d=False, momentum=0.0):
    reconstruction = phase == "reconstruction"
    variables = start_weights(reconstruction)
    jmodel = jfcn.FCNLectureNet(jfcn.FCNConfig(**TINY),
                                reconstruction_mode=reconstruction,
                                s2d_train=jax_s2d)
    jtrainer = JAXTrainer(jmodel, 0.05, momentum=momentum, phase=phase,
                          use_weights=use_weights, freeze_bn=freeze_bn,
                          fold_frozen_bn=fold, clip_norm=clip_norm)
    state = jtrainer.init_state(None, variables=jax.tree.map(jnp.asarray,
                                                             variables))
    model = tfcn.FCNLectureNet(tfcn.FCNConfig(**TINY), reconstruction)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    trainer = Trainer(model, 0.05, momentum=momentum, phase=phase,
                      use_weights=use_weights, freeze_bn=freeze_bn,
                      fold_frozen_bn=fold, clip_norm=clip_norm,
                      prefetch_depth=0, device="cpu")
    for step in range(3):
        data = batch(step)
        state, theirs = jtrainer.step(state, data)
        ours = trainer.step(data)
        assert sorted(ours) == sorted(theirs)
        for key in theirs:
            np.testing.assert_allclose(float(ours[key]), float(theirs[key]),
                                       rtol=LOSS_RTOL,
                                       err_msg=f"step {step} {key}")
    expected = state_dict_from_flax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    got = trainer.model.state_dict()
    moved = 0
    for key, value in expected.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=key)
        moved += not torch.equal(value, state_dict_from_flax(
            variables)[key])
    assert moved > 0
    return trainer
