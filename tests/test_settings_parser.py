"""The in-repo OpenCV-FileStorage parser against a YAML library's reading
of every settings file the repository ships."""

import glob
import os

import numpy as np
import pytest

from orb_slam3_ros2_tpu.io import settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "config", "**", "*.yaml"),
                       recursive=True)
    + glob.glob(os.path.join(ROOT, "tests", "data", "*.yaml"))
)


def _yaml_reference(path):
    """The FileStorage dialect read through PyYAML: directive and matrix
    tags stripped, matrices reshaped to float64 (rows, cols)."""
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        lines = f.read().splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]
    data = yaml.safe_load("\n".join(lines).replace("!!opencv-matrix", ""))
    out = {}
    for k, v in (data or {}).items():
        if isinstance(v, dict) and "data" in v and "rows" in v:
            v = np.asarray(v["data"], np.float64).reshape(
                int(v["rows"]), int(v["cols"]))
        out[k] = v
    return out


def test_settings_files_found():
    assert len(FILES) >= 25


@pytest.mark.parametrize("rel", FILES)
def test_filestorage_parser_matches_yaml_library(rel):
    path = os.path.join(ROOT, rel)
    want = _yaml_reference(path)
    got = settings.load_opencv_yaml(path)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == np.float64
            np.testing.assert_array_equal(got[k], v)
        else:
            assert type(got[k]) is type(v), (k, got[k], v)
            assert got[k] == v, k


def test_filestorage_scalars_and_multiline_matrix(tmp_path):
    p = tmp_path / "s.yaml"
    p.write_text(
        "%YAML:1.0\n---\n"
        "a.int: 12  # trailing comment\n"
        "a.neg: -3\n"
        "a.float: 1.5e-04\n"
        "a.str: \"x # not a comment\"\n"
        "a.bare: maps/atlas\n"
        "M: !!opencv-matrix\n"
        "  rows: 2\n"
        "  cols: 2\n"
        "  dt: d\n"
        "  data: [1.0, 2.0,\n"
        "         3.0, 4.0]\n"
        "after: 7\n")
    d = settings.load_opencv_yaml(str(p))
    assert d["a.int"] == 12 and isinstance(d["a.int"], int)
    assert d["a.neg"] == -3
    assert d["a.float"] == pytest.approx(1.5e-4)
    assert d["a.str"] == "x # not a comment"
    assert d["a.bare"] == "maps/atlas"
    np.testing.assert_array_equal(d["M"], [[1.0, 2.0], [3.0, 4.0]])
    assert d["after"] == 7
