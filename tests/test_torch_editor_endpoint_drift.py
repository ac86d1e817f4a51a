"""The port's browser UIs are endpoint-driven like the JAX package's: the
JAX package's static audit of every page (each /api/ route the page
fetches is routed by its module's handler, each DOM id its script looks up
exists, each /img/ route it loads is served) runs on the port's four
editor modules, and each port page is its JAX counterpart's, character for
character, so the browser UI stays the same."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("gt_editor", "annotation_editor", "word_editor",
           "st3d_visualizer")


def _source(package, name):
    with open(os.path.join(REPO, package, "utils", f"{name}.py")) as f:
        return f.read()


def _page(src):
    return re.search(r'PAGE = """(.*?)"""', src, re.S).group(1)


def _handler(src):
    return src[src.index("def make_handler"):]


@pytest.mark.parametrize("name", MODULES)
def test_every_js_endpoint_is_routed(name):
    src = _source("lecturemath_tpu_torch", name)
    page, handler = _page(src), _handler(src)
    # template-interpolated suffixes ("/api/x/" + idx) appear with a
    # trailing slash: normalize to the route prefix
    js_endpoints = {e.split("$")[0].rstrip("/")
                    for e in re.findall(r"/api/[A-Za-z0-9_/${}]+", page)}
    routed = {r.rstrip("/") for r in
              re.findall(r'startswith\("(/api/[A-Za-z0-9_/]+)"\)', handler)}
    # the word annotator routes POST /api/<tool>/<op> generically
    generic = 'parts[0] != "api"' in handler
    assert js_endpoints, f"{name}: no endpoints extracted"
    for endpoint in js_endpoints:
        if generic and re.fullmatch(r"/api/\w+/\w+", endpoint):
            continue
        assert endpoint in routed, \
            f"{name}: page JS fetches {endpoint} but the handler does not " \
            f"route it"


@pytest.mark.parametrize("name", MODULES)
def test_every_dom_id_the_js_touches_exists(name):
    page = _page(_source("lecturemath_tpu_torch", name))
    looked_up = set(re.findall(
        r"""getElementById\(\s*['"]([\w-]+)['"]\s*\)""", page))
    assert looked_up, f"{name}: no getElementById calls found"
    defined = set(re.findall(r"""\bid=["']([\w-]+)["']""", page))
    defined |= set(re.findall(r"""\.id\s*=\s*['"]([\w-]+)['"]""", page))
    missing = looked_up - defined
    assert not missing, \
        f"{name}: page JS references missing DOM id(s) {sorted(missing)}"


@pytest.mark.parametrize("name", MODULES)
def test_every_img_route_the_js_uses_is_served(name):
    src = _source("lecturemath_tpu_torch", name)
    page, handler = _page(src), _handler(src)
    # a route built in the script ('/img/' + tool()) counts as its prefix
    js_imgs = {e.split("$")[0].rstrip("/")
               for e in re.findall(r"/img/[A-Za-z0-9_/${}]*", page)}
    assert js_imgs, f"{name}: the page loads no /img/ route"
    routed = set()
    for group in re.findall(r'startswith\(\(([^)]*)\)\)', handler):
        routed |= {r.rstrip("/") for r in
                   re.findall(r'"(/img/[A-Za-z0-9_/]+)"', group)}
    routed |= {r.rstrip("/") for r in
               re.findall(r'startswith\("(/img/[A-Za-z0-9_/]*)"\)', handler)}
    for img in js_imgs:
        assert any(img == r or img.startswith(r + "/") or r.startswith(img)
                   for r in routed), \
            f"{name}: page JS loads {img} but the handler serves no " \
            f"matching /img route"


@pytest.mark.parametrize("name", MODULES)
def test_page_equals_jax(name):
    """The page string itself, imported from both packages."""
    import importlib

    ours = importlib.import_module(f"lecturemath_tpu_torch.utils.{name}")
    theirs = importlib.import_module(f"lecturemath_tpu.utils.{name}")
    assert ours.PAGE == theirs.PAGE
    assert len(ours.PAGE) > 2000


@pytest.mark.parametrize("name", MODULES)
def test_handler_imports_no_opencv(name):
    """No server or handler of the port imports cv2: the PNGs it serves
    come from utils/png.py."""
    handler = _handler(_source("lecturemath_tpu_torch", name))
    handler = handler[:handler.index("\ndef serve")]
    assert "cv2" not in handler and "encode_png(" in handler
