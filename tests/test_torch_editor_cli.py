"""The port's four editor CLIs as a user runs them: each starts its server
from a config and a lecture (``-port 0`` binds a free port), prints where
it serves, and answers the page's first request; without arguments each
prints its usage. The workspace holds a GT tree, a PNG image-list lecture
and the stage-02/03 artifacts, all written by the port."""

import json
import os
import subprocess
import sys
import urllib.request

import pytest

from lecturemath_tpu_torch.cli import (annotation_editor, gt_editor,
                                       st3d_visualizer, word_annotator)
from lecturemath_tpu_torch.core.artifacts import ArtifactStore
from lecturemath_tpu_torch.eval.gt_authoring import export_gt_tree
from lecturemath_tpu_torch.pipeline.video import compress_png

import _torch_editor_scenario as scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DB_XML = """<AccessMath><DataBase><Name>CLDB</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Testing><LectureTitle>cl01</LectureTitle></Testing></Datasets>
<Lectures><Lecture><Id>cl01</Id><Title>cl01</Title><Parameters></Parameters>
<Videos><Main><Video><Path>cl01</Path></Video></Main></Videos>
</Lecture></Lectures></DataBase></AccessMath>
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("editor_cli")
    (root / "db.xml").write_text(DB_XML)
    conf = root / "editors.conf"
    conf.write_text(
        f"VIDEO_DATABASE_PATH = {root}/db.xml\n"
        f"VIDEO_FILES_PATH = {root}/videos\n"
        f"OUTPUT_PATH = {root}/output\n"
        "CC_STABILITY_OUTPUT = tempo_stability_\n"
        "CC_ST3D_OUTPUT = tempo_cc_ST3D_\n"
        "CC_RECONSTRUCTED_OUTPUT = tempo_bin_reconstructed_\n")
    frames = scenario.keyframes()
    export_gt_tree(str(root / "output" / "annotations"), "CLDB", "cl01",
                   list(scenario.KEYFRAMES), list(scenario.TIMES),
                   [b for b, _ in frames], [r for _, r in frames])
    os.makedirs(root / "videos")
    os.rename(scenario.image_list(str(root)), root / "videos" / "cl01")

    session = scenario.st3d_session("lecturemath_tpu_torch")
    store = ArtifactStore(str(root / "output" / "temporal"))
    store.save((session.frame_times, session.frame_indices,
                session.tracker), "tempo_stability_", "cl01")
    store.save(session.st3d, "tempo_cc_ST3D_", "cl01")
    store.save((session.frame_times, session.frame_indices,
                compress_png(session.clean_frames)),
               "tempo_bin_reconstructed_", "cl01")
    return {"conf": str(conf), "session": session}


def _serve_once(module, conf, path):
    """Start ``python -m <module> conf -l cl01 -port 0``, read the URL it
    prints, GET ``path`` there; returns (first line, decoded JSON)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"lecturemath_tpu_torch.cli.{module}", conf,
         "-l", "cl01", "-port", "0"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        for _ in range(5):   # the ST3D CLI prints its lecture first
            line = proc.stdout.readline()
            if "http://" in line or not line:
                break
        assert "http://127.0.0.1:" in line, (line, proc.stderr.read()
                                              if proc.poll() is not None
                                              else "")
        base = line.split("http://", 1)[1].split("/", 1)[0]
        with urllib.request.urlopen(f"http://{base}{path}",
                                    timeout=30) as r:
            return line, json.loads(r.read())
    finally:
        proc.kill()
        proc.communicate(timeout=30)


@pytest.mark.parametrize("module,path,check", [
    ("gt_editor", "/api/state",
     lambda s: s["keyframes"] == list(scenario.KEYFRAMES)),
    ("word_annotator", "/api/state?tool=ccs",
     lambda s: len(s["keyframes"]) == len(scenario.KEYFRAMES)),
    ("annotation_editor", "/api/state",
     lambda s: s["total_frames"] == scenario.LIST_FRAMES),
    ("st3d_visualizer", "/api/state",
     lambda s: s["n_samples"] == 20 and s["has_reconstructed"]),
])
def test_cli_serves_the_lecture(workspace, module, path, check):
    line, state = _serve_once(module, workspace["conf"], path)
    assert "cl01" in line
    assert check(state), state


@pytest.mark.parametrize("module", [gt_editor, word_annotator,
                                    annotation_editor, st3d_visualizer])
def test_cli_usage(module, capsys):
    module.main(["prog"])
    out = capsys.readouterr().out
    assert "Usage" in out and "config" in out


@pytest.mark.parametrize("module", [gt_editor, word_annotator])
def test_cli_refuses_a_missing_tree(workspace, module, tmp_path):
    conf = tmp_path / "empty.conf"
    conf.write_text(open(workspace["conf"]).read().replace(
        "/output\n", "/nowhere\n"))
    with pytest.raises(FileNotFoundError, match="no annotation tree"):
        module.main(["prog", str(conf), "-l", "cl01"])


def test_usage_docstrings_name_the_port():
    for module in (gt_editor, word_annotator, annotation_editor,
                   st3d_visualizer):
        assert "python -m lecturemath_tpu_torch.cli." in module.__doc__
        assert "lecturemath_tpu." not in module.__doc__
