"""The port's copies of pbrt's tools (grail_torch/tools/bsdftest.py, exravg.py,
exrdiff.py, obj2pbrt.py) against the reference's grail/tools/.

Held: exravg's and exrdiff's printed lines and exit codes on goldens (with
and without a tolerance, and exrdiff's difference image, bitwise);
obj2pbrt's text, character for character, from an OBJ and MTL written here
(a quad and a pentagon fanned, negative and v/vt/vn indices, a matte and a
plastic material, a face with no material), and both parsers reading it
leaf for leaf (tests/test_torch_parser.py's assert_same_scene); bsdftest
at 1,024 samples on the CPU: the reference's verdicts and exit code, and
its rho estimates within 1e-4 (its 4 printed decimals).
"""
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from grail.scene import parser as jparser
from grail.tools import bsdftest as jbsdftest
from grail.tools import exravg as jexravg
from grail.tools import exrdiff as jexrdiff
from grail.tools import obj2pbrt as jobj2pbrt
from grail_torch.engine.imageio import read_image
from grail_torch.scene import parser as tparser
from grail_torch.tools import bsdftest, exravg, exrdiff, obj2pbrt
from tests.test_torch_parser import assert_same_scene

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    return rc, out.getvalue()


def golden(name):
    return os.path.join(GOLDENS, name + ".exr")


def test_exravg_matches_reference():
    paths = [golden("cornell"), golden("glossy")]
    rc, out = printed(exravg.main, paths)
    assert (rc, out) == printed(jexravg.main, paths)
    assert rc == 0 and len(out.splitlines()) == 2


@pytest.mark.parametrize("case", ["plain", "tolerance", "outfile"])
def test_exrdiff_matches_reference(case, tmp_path):
    args = [golden("glossy"), golden("envlight")]
    if case == "tolerance":
        args += ["1.5"]
    if case == "outfile":
        args = ["-o", str(tmp_path / "port.exr")] + args
    rc, out = printed(exrdiff.main, args)
    if case == "outfile":
        args[1] = str(tmp_path / "ref.exr")
    assert (rc, out) == printed(jexrdiff.main, args)
    assert rc == (1 if case == "tolerance" else 0) and "pixels differ" in out
    if case == "outfile":
        np.testing.assert_array_equal(read_image(str(tmp_path / "port.exr")),
                                      read_image(str(tmp_path / "ref.exr")))


OBJ = """# a quad, a pentagon and a triangle
mtllib m.mtl
v 0 0 0
v 1 0 0
v 1 0 1
v 0 0 1
v 0.5 1 0.5
v 2 0 0
v 2.5 0.5 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 1 0
f 3 4 5
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl shiny
f 1 2 5 6 7
f -1 -2 -3
"""
MTL = """newmtl red
Kd 0.8 0.1 0.1
newmtl shiny
Kd 0.2 0.3 0.4
Ks 0.5 0.5 0.5
d 1
"""
HEADER = """LookAt 1 2 4  1 0.3 0.5  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "path"
WorldBegin
LightSource "point" "point from" [0 3 2] "rgb I" [5 5 5]
"""


def test_obj2pbrt_matches_reference(tmp_path):
    (tmp_path / "m.mtl").write_text(MTL)
    obj = tmp_path / "model.obj"
    obj.write_text(OBJ)
    got, ref = io.StringIO(), io.StringIO()
    obj2pbrt.convert(str(obj), out=got)
    jobj2pbrt.convert(str(obj), out=ref)
    text = got.getvalue()
    assert text == ref.getvalue()
    assert text.count('Shape "trianglemesh"') == 3 and 'Material "plastic"' in text
    assert printed(obj2pbrt.main, []) == printed(jobj2pbrt.main, []) == (1, "")
    scene = HEADER + text + "WorldEnd\n"
    assert_same_scene(tparser.parse_string(scene, device="cpu"), jparser.parse_string(scene))


def _rhos(out):
    rows = re.findall(r"^(OK |FAIL) (.+?)\s+rho\(Sample_f\)=(\S+) rho\(uniform\)=(\S+)", out,
                      re.M)
    return [(ok, name) for ok, name, _, _ in rows], np.asarray(
        [(float(a), float(b)) for _, _, a, b in rows])


def test_bsdftest_matches_reference():
    rc, out = printed(bsdftest.main, ["1024", "--cpu"])
    ref_rc, ref_out = printed(jbsdftest.run, 1024)
    got, ref = _rhos(out), _rhos(ref_out)
    assert rc == ref_rc and got[0] == ref[0] and len(got[0]) == len(bsdftest.CASES)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
