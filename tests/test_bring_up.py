"""Running on the GPU: the smoke script's phases at tiny sizes, its refusal
to run without a GPU, the compile-cache location, the import surface of
the main path, and the rule that no module targets another accelerator."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from orb_slam3_ros2_tpu.utils import compile_cache
from orb_slam3_ros2_tpu.utils.device import require_gpu

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_device_check_refuses_cpu_only_run():
    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="no GPU found"):
        require_gpu([])


def test_smoke_main_refuses_cpu_and_prints_no_result(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_phase_kernels_tiny():
    lines = chip_smoke.phase_kernels(height=120, width=160, n_features=200,
                                     n_levels=3, n_landmarks=512)
    assert len(lines) == 4 and "indices identical" in lines[2]


def test_smoke_phase_tracking_tiny():
    lines = chip_smoke.phase_tracking(height=240, width=320, n_features=500,
                                      n_levels=4, max_lm=2048,
                                      n_map_frames=4, min_inliers=50)
    assert "memory_analysis" in lines[0] and "inliers" in lines[1]


def test_smoke_phase_global_ba_tiny():
    (line,) = chip_smoke.phase_global_ba(K=8, L=512, n_iters=4)
    assert "rel diff" in line


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text()


def test_no_module_targets_another_accelerator():
    """One place picks an implementation per platform
    (pose_opt_fused.choose_impl); nothing imports another accelerator's
    Pallas dialect or compares the backend with its name."""
    files = [*ROOT.glob("orb_slam3_ros2_tpu/**/*.py"),
             *ROOT.glob("scripts/*.py"), ROOT / "bench.py",
             ROOT / "__graft_entry__.py", ROOT / "chip_smoke.py"]
    bad = re.compile(r"pallas\.[t]pu|pallas import [t]pu|pl[t]pu|"
                     r"""default_backend\(\)\s*[!=]=\s*["'][t]pu["']""")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if bad.search(line)]
    assert not hits, hits
    choosers = [p for p in files
                if "default_backend()" in p.read_text()
                and p.name not in ("chip_smoke.py",
                                   "profile_tracking.py")]
    assert [p.name for p in choosers] == ["pose_opt_fused.py"], choosers


BLOCKED_IMPORT_RUN = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cv2", "yaml"):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, Block())
import numpy as np
from orb_slam3_ros2_tpu.io import synthetic
from orb_slam3_ros2_tpu.runtime.system import Sensor, System

images, R, t, ts = synthetic.render_sequence(
    n_frames=3, width=320, height=240, fx=260.0, fy=260.0, seed=1)
s = System(None, "tests/data/synth_cam.yaml", Sensor.MONOCULAR)
for k in range(3):
    s.track_monocular(images[k], float(ts[k]))
assert "cv2" not in sys.modules and "yaml" not in sys.modules
print("OK", len(s.get_trajectory()))
"""


def test_main_path_runs_without_cv2_and_yaml():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT_RUN],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().startswith("OK")


@pytest.mark.gpu
def test_smoke_phase_kernels_on_gpu(gpu):
    assert len(chip_smoke.phase_kernels()) == 4


def test_numpy_renderer_matches_opencv():
    """The numpy resampling reproduces OpenCV's warpPerspective, remap,
    cubic resize and Gaussian blur to float rounding."""
    cv2 = pytest.importorskip("cv2")
    from orb_slam3_ros2_tpu.io import synthetic

    rng = np.random.default_rng(0)
    src = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    M = np.array([[1.3, 0.1, -5.3], [0.05, 1.2, -3.1], [1e-4, 2e-4, 1.0]])
    want = cv2.warpPerspective(src, M, (90, 70), flags=cv2.INTER_LINEAR,
                               borderValue=-1.0)
    got = synthetic._warp_perspective(src, M, 90, 70)
    inside = want >= 0
    assert inside.mean() > 0.5
    np.testing.assert_allclose(got[inside], want[inside], atol=0.01)
    assert np.all(got[~inside] < 0.5)

    Mi = np.linalg.inv(M)
    uu, vv = np.meshgrid(np.arange(90.0), np.arange(70.0))
    w = Mi[2, 0] * uu + Mi[2, 1] * vv + Mi[2, 2]
    mx = ((Mi[0, 0] * uu + Mi[0, 1] * vv + Mi[0, 2]) / w).astype(np.float32)
    my = ((Mi[1, 0] * uu + Mi[1, 1] * vv + Mi[1, 2]) / w).astype(np.float32)
    want = cv2.remap(src, mx, my, cv2.INTER_LINEAR, borderValue=-1.0)
    got = synthetic._bilinear_lookup(src, mx, my, -1.0)
    np.testing.assert_allclose(got[inside], want[inside], atol=0.01)

    g = rng.uniform(0, 1, (9, 9)).astype(np.float32)
    np.testing.assert_allclose(
        synthetic._resize_cubic(g, 100, 70),
        cv2.resize(g, (100, 70), interpolation=cv2.INTER_CUBIC), atol=1e-5)
    im = rng.uniform(0, 255, (50, 60))
    np.testing.assert_allclose(synthetic._gaussian_blur(im, 0.6),
                               cv2.GaussianBlur(im, (0, 0), 0.6), atol=1e-9)


def test_area_resize_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    from orb_slam3_ros2_tpu.runtime.system import resize_area

    im = np.random.default_rng(1).uniform(0, 255, (480, 752)).astype(
        np.float32)
    np.testing.assert_allclose(
        resize_area(im, 600, 350),
        cv2.resize(im, (600, 350), interpolation=cv2.INTER_AREA), atol=1e-3)
