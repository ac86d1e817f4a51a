"""The port's full-lecture drive (flagship_drive_torch.py) against the JAX
package's (flagship_drive.py) at the tiny recipe, on the CPU.

Both drives read their recipe from the environment when they are imported,
so each test sets it and imports both afresh. Every compared output is
integer, file bytes or printed metrics of the same integer CCs, so every
comparison is exact:

  (a) both build_workspace write a byte-identical MJPG AVI, the same
      db.xml and the same config apart from the root path;
  (b) both gt_phase write GT trees equal by sha256 and equal gt_stats.json;
  (c) one checkpoint (the JAX package's seeded threshold heads at tiny
      widths) serves both step tables, run in-process through each
      package's CLI main(argv), the port's with -device cpu: intervals,
      the staged and express summaries (keyframe PNGs and XML) and the
      keyframe_bin and eval_summaries metric lines are identical;
  (d) the port's train_phase writes finite losses under the JAX drive's
      train_stats.json keys, and a .msgpack the JAX package loads with its
      own tree structure;
  (e) the drive run as a user runs it, with -device cpu, writes its report
      into the workdir; without -device cpu and without a card it raises
      before it renders the lecture.

Then the drive's own pieces: the report keeps one section a frame count
and resolution, a workdir of another recipe raises, the workdir defaults
into TMPDIR, and the children's peak-RSS sampler sees an allocation.
"""

import ast
import hashlib
import importlib
import json
import os
import pickle
import runpy
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_ENV = {
    "LM_FLAGSHIP_TINY": "1",
    "LM_FLAGSHIP_FRAMES": "30",
    "LM_FLAGSHIP_HEIGHT": "96",
    "LM_FLAGSHIP_WIDTH": "160",
    "LM_FLAGSHIP_BOARDS": "2",
    "LM_FLAGSHIP_GLYPHS": "6",
    "LM_FLAGSHIP_TRAIN_STEPS": "2",
    "LM_FLAGSHIP_CROP": "64",
}

torch.set_num_threads(1)


@pytest.fixture
def drives(monkeypatch):
    """(the JAX drive, the port's drive), imported under the tiny recipe."""
    for key, value in TINY_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.syspath_prepend(REPO)
    modules = []
    for name in ("flagship_drive", "flagship_drive_torch"):
        sys.modules.pop(name, None)
        modules.append(importlib.import_module(name))
    yield tuple(modules)
    for name in ("flagship_drive", "flagship_drive_torch"):
        sys.modules.pop(name, None)


def tree_digest(root):
    """{relative path: sha256} of every file under ``root``."""
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_recipe_and_steps_mirror_the_jax_drive(drives):
    jax_drive, port = drives
    for name in ("DB_NAME", "LECTURE", "N_FRAMES", "HEIGHT", "WIDTH",
                 "N_BOARDS", "GLYPHS_PER_BOARD", "PRODUCTION_WIDTHS",
                 "TRAIN_STEPS", "TRAIN_BATCH", "TRAIN_CROP"):
        assert getattr(port, name) == getattr(jax_drive, name), name
    assert [label for label, *_ in port.STEPS] == [
        "train checkpoint", "stage01 binarize", "stage02 cc_analysis",
        "stage03 cc_grouping", "stage04 vid_segmentation",
        "stage05 generate_summary", "express run_pipeline", "gt authoring",
        "eval keyframe_bin", "eval summaries"]
    assert port.STEPS[8][1] == "scripts_torch/lecturenet_eval_keyframe_bin.py"


def test_workspace_identical(drives, tmp_path):
    jax_drive, port = drives
    roots = [str(tmp_path / "jax"), str(tmp_path / "port")]
    confs = [drive.build_workspace(root)
             for drive, root in zip(drives, roots)]
    video = os.path.join("videos", f"{port.LECTURE}.avi")
    avis = [open(os.path.join(root, video), "rb").read() for root in roots]
    assert len(avis[0]) > 0 and avis[0] == avis[1]
    dbs = [open(os.path.join(root, "db.xml")).read() for root in roots]
    assert dbs[0] == dbs[1]
    texts = [open(conf).read().replace(root, "<root>")
             for conf, root in zip(confs, roots)]
    assert texts[0] == texts[1]
    assert "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = 7" in texts[1]


def test_gt_tree_identical(drives, tmp_path):
    """Both GT phases in one workspace, in turn (segments.xml names its own
    path)."""
    root = str(tmp_path)
    drives[1].build_workspace(root)
    annotations = os.path.join(root, "output", "annotations")
    trees, stats = [], []
    for drive in drives:
        drive.gt_phase(root)
        trees.append(tree_digest(annotations))
        stats.append(json.load(open(os.path.join(root, "gt_stats.json"))))
        shutil.rmtree(annotations)
        os.remove(os.path.join(root, "gt_stats.json"))
    assert len(trees[0]) >= 8 and trees[0] == trees[1]
    assert stats[0] == stats[1] and stats[1]["gt_ccs"] > 0


# ------------------------------------------------------------ (c) pipeline

def _script_main(path):
    """``main`` of a wrapper script, loaded from its file."""
    return runpy.run_path(path, run_name="wrapper")["main"]


def _jax_steps(jax_drive, root, conf, model):
    """The JAX drive's step table (flagship_drive.py main), train left out:
    (label, call)."""
    stage = ("lecturemath_tpu.cli.binarize", "lecturemath_tpu.cli.cc_analysis",
             "lecturemath_tpu.cli.cc_grouping",
             "lecturemath_tpu.cli.vid_segmentation",
             "lecturemath_tpu.cli.generate_summary")
    labels = ("stage01 binarize", "stage02 cc_analysis",
              "stage03 cc_grouping", "stage04 vid_segmentation",
              "stage05 generate_summary")

    def cli(module):
        return lambda: importlib.import_module(module).main(
            [module, conf, "-d", "testing"])

    script = os.path.join(REPO, "scripts", "lecturenet_eval_keyframe_bin.py")
    return ([(label, cli(module)) for label, module in zip(labels, stage)]
            + [("express run_pipeline",
                cli("lecturemath_tpu.cli.run_pipeline")),
               ("gt authoring", lambda: jax_drive.gt_phase(root)),
               ("eval keyframe_bin",
                lambda: _script_main(script)([script, conf, model, "1"])),
               ("eval summaries", cli("lecturemath_tpu.cli.eval_summaries"))])


def _port_steps(port, root, conf):
    """The port drive's STEPS, train left out, each called in-process as
    its command would run it, with -device cpu: (label, call)."""
    steps = []
    for label, target, args in port.STEPS[1:]:
        argv = port.step_command(target, args, root, conf, "cpu")
        if target == "--gt":
            assert argv == [port.ME, "--gt", root, "-device", "cpu"]
            call = (lambda: port.gt_phase(root))
        else:
            assert argv[:2] == [port.ME, "--child"]
            argv = argv[2:]
            if target.endswith(".py"):
                call = (lambda argv=argv: _script_main(argv[0])(argv))
            else:
                call = (lambda argv=argv: importlib.import_module(
                    argv[1]).main(argv[1:]))
        steps.append((label, call))
    return steps


def _run_table(steps, capsys, root, summary):
    """Run the steps; returns {label: stdout} and the summary tree's digest
    after stage 05 (before express writes over it) and after express."""
    out, digests = {}, {}
    capsys.readouterr()
    for label, call in steps:
        call()
        out[label] = capsys.readouterr().out
        if label in ("stage05 generate_summary", "express run_pipeline"):
            digests[label] = tree_digest(summary)
    return out, digests


def _metric_lines(text):
    """Printed lines without those that print a time."""
    return [line for line in text.splitlines()
            if "time" not in line.lower()]


def test_step_tables_give_identical_outputs(drives, tmp_path, capsys):
    jax_drive, port = drives
    from lecturemath_tpu.core.config import Config as JaxConfig
    from lecturemath_tpu.models.fcn_lecturenet import FCNConfig as JaxFCNConfig
    from lecturemath_tpu.pipeline.binarize import save_checkpoint_variables
    from lecturemath_tpu.utils.synthetic import threshold_binarizer_variables

    root = str(tmp_path)
    conf = port.build_workspace(root)
    model = os.path.join(root, "models", port.MODEL_FILE)
    save_checkpoint_variables(threshold_binarizer_variables(
        JaxFCNConfig.from_config(JaxConfig.from_file(conf))), model)
    output = os.path.join(root, "output")
    summary = os.path.join(output, "summaries",
                           f"{port.DB_NAME}_{port.LECTURE}")
    intervals = os.path.join(output, "temporal",
                             f"tempo_intervals_{port.LECTURE}.dat")

    runs = []
    for steps in (_jax_steps(jax_drive, root, conf, model),
                  _port_steps(port, root, conf)):
        out, digests = _run_table(steps, capsys, root, summary)
        with open(intervals, "rb") as f:
            runs.append((out, digests, pickle.load(f)))
        # the next package starts from the same workspace and checkpoint
        shutil.move(output, output + f".{len(runs)}")
        os.makedirs(output)

    (jax_out, jax_digests, jax_intervals), (out, digests, got) = runs
    assert got == jax_intervals and len(got) >= 2
    assert digests == jax_digests
    staged = digests["stage05 generate_summary"]
    assert sum(name.endswith(".png") for name in staged) >= 2
    assert digests["express run_pipeline"] == staged
    for label in ("eval keyframe_bin", "eval summaries"):
        lines = _metric_lines(out[label])
        assert lines == _metric_lines(jax_out[label]), label
        assert any(ch.isdigit() for line in lines for ch in line)
    assert any(line.startswith("fmeasure")
               for line in out["eval keyframe_bin"].splitlines())


# ------------------------------------------------------------ (d) training

def _jax_train_stats_keys():
    """The keys of the dict flagship_drive.py's train_phase dumps to
    train_stats.json, read from its source."""
    with open(os.path.join(REPO, "flagship_drive.py")) as f:
        tree = ast.parse(f.read())
    train = next(node for node in tree.body
                 if isinstance(node, ast.FunctionDef)
                 and node.name == "train_phase")
    dumps = [node for node in ast.walk(train)
             if isinstance(node, ast.Call) and getattr(
                 node.func, "attr", "") == "dump"]
    return sorted(key.value for key in dumps[0].args[0].keys)


def test_train_phase_writes_a_checkpoint_the_jax_package_loads(drives,
                                                               tmp_path):
    import jax

    from lecturemath_tpu.models.fcn_lecturenet import FCNConfig as JaxFCNConfig
    from lecturemath_tpu.pipeline.binarize import load_checkpoint_variables
    from lecturemath_tpu.utils.synthetic import threshold_binarizer_variables

    _, port = drives
    root = str(tmp_path)
    port.build_workspace(root)
    port.train_phase(root, "cpu")
    stats = json.load(open(os.path.join(root, "train_stats.json")))
    assert sorted(stats) == _jax_train_stats_keys()
    assert stats["steps"] == 2 and len(stats["losses"]) == 2
    assert all(np.isfinite(loss) for _, loss in stats["losses"])
    assert 0.0 <= stats["pixel_acc"] <= 1.0

    loaded = load_checkpoint_variables(
        os.path.join(root, "models", port.MODEL_FILE))
    widths = port.PRODUCTION_WIDTHS
    reference = threshold_binarizer_variables(JaxFCNConfig(
        down_filters=widths["DOWN_CONV_FILTERS"],
        mid_filters=widths["MIDDLE_CONV_FILTERS_MIDDLE"],
        upsample_filters=widths["UPSAMPLE_FILTERS"],
        up_filters=widths["UP_CONV_FILTERS"],
        pixel_features=widths["PIXEL_FEATURES"],
        kernel_size=3, pixel_kernel_size=7))
    assert (jax.tree_util.tree_structure(loaded)
            == jax.tree_util.tree_structure(reference))
    assert ([np.shape(leaf) for leaf in jax.tree_util.tree_leaves(loaded)]
            == [np.shape(leaf)
                for leaf in jax.tree_util.tree_leaves(reference)])


# ------------------------------------------------------------ (e) the drive

def test_drive_writes_its_report_into_the_workdir(tmp_path):
    root = tmp_path / "ws"
    report = os.path.join(REPO, "FLAGSHIP_DRIVE_TORCH.md")
    before = (os.path.getmtime(report) if os.path.exists(report) else None)
    env = dict(os.environ, **TINY_ENV, CUDA_VISIBLE_DEVICES="")
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "flagship_drive_torch.py"),
         str(root), "-device", "cpu"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, (result.stdout[-3000:]
                                    + result.stderr[-3000:])
    text = (root / "FLAGSHIP_DRIVE_TORCH.md").read_text()
    assert "| stage02 cc_analysis |" in text and "fmeasure" in text
    rows = [line.split(" | ") for line in text.splitlines()
            if line.startswith("| ") and " | no | " in line]
    assert len(rows) == 10   # every step, none on the card
    assert all(float(row[4]) > 0 for row in rows)   # peak RSS, sampled
    assert "Summary keyframes exported: 2" in text
    after = (os.path.getmtime(report) if os.path.exists(report) else None)
    assert after == before
    assert not (root / "FLAGSHIP_DRIVE.md").exists()
    for name in ("train_checkpoint", "stage01_binarize", "eval_summaries"):
        assert (root / "logs" / f"{name}.log").exists()


def test_drive_without_a_card_raises_before_rendering(drives, tmp_path,
                                                      monkeypatch):
    _, port = drives
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-device cpu"):
        port.main([str(tmp_path / "ws")])
    assert not (tmp_path / "ws").exists()


# ------------------------------------------------------ the drive's pieces

def _fake_run(root, label_walls):
    """A workspace and step records as report() reads them."""
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    with open(os.path.join(root, "videos", "flag01.avi"), "wb") as f:
        f.write(b"\0" * 1000)
    with open(os.path.join(root, "train_stats.json"), "w") as f:
        json.dump({"steps": 2, "batch": 8, "crop": 64, "losses": [[0, 1.0]],
                   "train_wall_s": 0.1, "pixel_acc": 0.5,
                   "checkpoint_mb": 0.1}, f)
    with open(os.path.join(root, "gt_stats.json"), "w") as f:
        json.dump({"keyframes": 2, "gt_ccs": 10, "segments": 2}, f)
    records = {}
    for label, wall in label_walls.items():
        records[label] = {"wall_s": wall, "stdout": f"{label} printed\n",
                          "rss_mb": 100.0,
                          "launches": {"threshold_pack": 1,
                                       "conv_same_nhwc": 4, "cc_label": 0}}
    records["stage01 binarize"]["card_peak_bytes"] = 2**30
    records["express run_pipeline"]["in_run_s"] = 3.0
    return records


def test_report_keeps_one_section_a_run(drives, tmp_path, monkeypatch):
    _, port = drives
    root = str(tmp_path)
    labels = [label for label, *_ in port.STEPS]
    out = str(tmp_path / "report.md")

    def write(frames, wall):
        monkeypatch.setattr(port, "N_FRAMES", frames)
        port.report(root, _fake_run(root, dict.fromkeys(labels, wall)),
                    wall, "card X, 1 W", 1.0, out=out)
        with open(out) as f:
            return f.read()

    write(60, 1.5)
    write(30, 2.5)
    text = write(60, 3.5)
    assert text.startswith(port.REPORT_TITLE)
    headings = [line for line in text.splitlines()
                if line.startswith(port.RUN_HEADING)]
    assert headings == ["## Run: 30 frames of 160x96",
                        "## Run: 60 frames of 160x96"]
    second = text.split("## Run: 60 frames")[1]
    assert "Total drive wall: 3.5s" in second
    assert "Total drive wall: 1.5s" not in text
    assert "Total drive wall: 2.5s" in text.split("## Run: 60 frames")[0]
    assert "| stage01 binarize | yes | 3.5 |" in second
    assert "| stage02 cc_analysis | no | 3.5 |" in second
    assert "LM_FLAGSHIP_FRAMES=30 " in text and "python3 " in text


def test_workspace_of_another_recipe_raises(drives, tmp_path, monkeypatch):
    _, port = drives
    root = str(tmp_path)
    conf = port.build_workspace(root)
    video = os.path.join(root, "videos", f"{port.LECTURE}.avi")
    mtime = os.path.getmtime(video)
    assert port.build_workspace(root) == conf   # same recipe: reused
    assert os.path.getmtime(video) == mtime
    with monkeypatch.context() as m:
        m.setattr(port, "N_FRAMES", port.N_FRAMES + 1)
        with pytest.raises(RuntimeError, match="another recipe"):
            port.build_workspace(root)
    os.remove(os.path.join(root, "recipe.json"))   # an unstamped workspace
    with pytest.raises(RuntimeError, match="another recipe"):
        port.build_workspace(root)


def test_default_workdir_is_in_tmpdir(drives, tmp_path, monkeypatch):
    import tempfile

    _, port = drives
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert port.default_workdir() == str(tmp_path / "flagship_torch_ws")


def test_peak_rss_sampler_sees_an_allocation(drives):
    import time

    _, port = drives
    rss = port._PeakRss()
    rss.start()
    before = rss.mb()
    block = np.ones(64 * 2**20, np.uint8)   # 64 MiB, touched
    time.sleep(0.2)
    del block
    time.sleep(0.05)
    assert rss.mb() >= before + 60
