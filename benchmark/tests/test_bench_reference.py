"""The plain reference against the port on the CPU: the forward at tiny and
at the published widths, the training samples, and the training steps. This
test may import both; the reference imports nothing of the port."""

import ast
import glob
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmark.harness import HERE
from benchmark.tests.conftest import TINY
from benchmark.traffic import pngio
from benchmark.traffic.lecture import Lecture, keyframes
from benchmark.traffic.weights import make_state, net_widths


def config(name, **over):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return dict(json.load(f), **over)


def port_model(net, state, **kwargs):
    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                             FCNLectureNet)

    model = FCNLectureNet(FCNConfig(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in net.items()}),
                          **kwargs)
    model.load_state_dict(state)
    return model.eval()


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(HERE, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            assert not any(n.split(".")[0].startswith("lecturemath_tpu")
                           or n.split(".")[0] in ("jax", "flax")
                           for n in names), path


@pytest.mark.parametrize("widths", ["tiny", "published"])
def test_forward_matches_the_port(widths):
    from benchmark.reference.fcn import Reference, model_input

    cfg = config("lecturenet-bin", **(TINY if widths == "tiny" else {}))
    net = net_widths(cfg)
    state = make_state(net, 2 ** 40 + 5, "cpu")
    lecture = Lecture(9, n_frames=20, height=120, width=200, n_boards=2,
                      glyphs_per_board=10, glyph_size=(20, 30))
    x = model_input(torch.from_numpy(np.stack(lecture.frames[-2:])))
    with torch.no_grad():
        ours = Reference(state, net)(x)
        theirs = port_model(net, state)(x)
    for a, b in zip(ours, theirs):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


def test_seeded_weights_follow_the_ink():
    """The seeded heads binarize the board's ink, whatever the trunk."""
    from benchmark.drivers._lecture import THRESHOLD_LOGIT
    from benchmark.reference.fcn import Reference, model_input

    net = net_widths(config("lecturenet-bin"))
    lecture = Lecture(4, n_frames=20, height=128, width=192, n_boards=1,
                      glyphs_per_board=12, glyph_size=(30, 40))
    x = model_input(torch.from_numpy(lecture.frames[-1][None].copy()))
    with torch.no_grad():
        logits = Reference(make_state(net, 4, "cpu"), net)(x)[0][0, 0]
    board = (logits.numpy() >= THRESHOLD_LOGIT)[:128, :192]
    assert np.mean(board == ~lecture.ink(19)) > 0.999


def test_training_samples_match_the_port():
    from benchmark.reference.augment import first_batches
    from lecturemath_tpu_torch.train.dataset import LectureNetDataset

    # colour changes on half the samples, so the HSV round trip is used
    cfg = config("lecturenet-train-bin", color_change_chance=0.5)
    images, truths = keyframes(6, 16, 300, 400, glyphs=30)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, (img, gt) in enumerate(zip(images, truths)):
            pair = (os.path.join(tmp, f"{k}.png"), os.path.join(tmp, f"{k}g.png"))
            for path, array in zip(pair, (img, gt)):
                with open(path, "wb") as f:
                    f.write(pngio.encode(array))
            paths.append(pair)
        dataset = LectureNetDataset(
            [p for p, _ in paths], [g for _, g in paths],
            crop_size=(256, 256), crop_min_fg_prc=cfg["crop_min_foreground"],
            flip_chance=0.5, color_invert_chance=0.5, color_change_chance=0.5,
            gaussian_noise_chance=0.2, gaussian_noise_level=5.0,
            weight_expansion=1, text_mask_expansion=15, seed=77)
        dataset.preload()
    ours = first_batches(images, truths, cfg, 77, 2)
    theirs = dataset.batches(8)
    for batch in ours:
        port = next(theirs)
        for key, value in batch.items():
            np.testing.assert_array_equal(value, port[key])


def test_png_round_trip():
    rgb = np.random.default_rng(0).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    gray = rgb[..., 0]
    np.testing.assert_array_equal(pngio.decode(pngio.encode(rgb)), rgb)
    np.testing.assert_array_equal(pngio.decode(pngio.encode(gray)), gray)
    from lecturemath_tpu_torch.utils.png import encode_png

    # the port's replies: filter Sub
    np.testing.assert_array_equal(pngio.decode(encode_png(gray)), gray)
