"""Settings parser (E13): reads the reference's OpenCV-FileStorage YAML
dialect verbatim, so all 24 configs under `/root/reference/config/` load
unchanged.

Dialect quirks handled (all observable in the snapshot):
* leading ``%YAML:1.0`` directive (`config/Monocular-Inertial/EuRoC.yaml:1`),
* ``!!opencv-matrix`` tagged maps with rows/cols/dt/data
  (`config/Monocular-Inertial/EuRoC.yaml:35-42`),
* dotted flat keys (``Camera1.fx``), both the new-style ``Camera1.*`` and
  any old-style ``Camera.fx`` spelling,
* fork-added plain keys like ``loopClosing``
  (`config/Monocular-Inertial/RealSense_D435i.yaml:9`).

The output is a typed `Settings` dataclass consumed by the engine; unknown
keys (e.g. ``Viewer.*``) are retained in `raw` — parsed-and-ignored, as
SURVEY.md E12 prescribes.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import numpy as np

from orb_slam3_ros2_tpu.models.cameras import Camera, make_camera


# YAML 1.1 plain-scalar forms, as a YAML 1.1 loader resolves them
_INT_RE = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT_RE = re.compile(
    r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$"
    r"|^[-+]?\.(inf|Inf|INF)$|^\.(nan|NaN|NAN)$")
_BOOLS = {"yes": True, "true": True, "on": True,
          "no": False, "false": False, "off": False}
_NULLS = {"", "~", "null", "Null", "NULL"}


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str):
    """One FileStorage value: quoted string, int, float, bool, null, or a
    plain string."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _FLOAT_RE.match(text):
        low = text.lower().lstrip("+")
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(text.replace("_", ""))
    if text.lower() in _BOOLS and text in (
            text.lower(), text.capitalize(), text.upper()):
        return _BOOLS[text.lower()]
    if text in _NULLS:
        return None
    return text


def _flow_list(text: str):
    inner = text.strip()
    if not (inner.startswith("[") and inner.endswith("]")):
        raise ValueError(f"expected a [..] list, got {text!r}")
    inner = inner[1:-1].strip()
    return [_scalar(v) for v in inner.split(",")] if inner else []


def load_opencv_yaml(path: str) -> Dict:
    """Parse an OpenCV-FileStorage YAML file into a flat dict.

    The dialect the settings files use: a ``%YAML:1.0`` directive, flat
    ``key: value`` lines with dotted keys, ``#`` comments, and
    ``!!opencv-matrix`` maps (indented ``rows``/``cols``/``dt``/``data``,
    where ``data`` is a ``[...]`` list that may span lines). Matrices come
    back as float64 arrays of shape (rows, cols); scalars resolve as a
    YAML 1.1 loader would resolve them."""
    with open(path, "r") as f:
        lines = [_strip_comment(l).rstrip() for l in f.read().splitlines()]
    out: Dict = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.lstrip().startswith("%") or \
                line.strip() == "---":
            continue
        if line[0] in " \t":
            raise ValueError(f"{path}: unexpected indented line {line!r}")
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"{path}: expected 'key: value', got {line!r}")
        key, value = key.strip(), value.strip()
        if value != "!!opencv-matrix":
            out[key] = _scalar(value)
            continue
        fields: Dict = {}
        while i < len(lines) and (not lines[i].strip()
                                  or lines[i][0] in " \t"):
            sub = lines[i].strip()
            i += 1
            if not sub:
                continue
            fk, _, fv = sub.partition(":")
            fv = fv.strip()
            if fv.startswith("[") and "]" not in fv:
                while i < len(lines) and "]" not in fv:
                    fv += " " + lines[i].strip()
                    i += 1
            fields[fk.strip()] = fv
        out[key] = np.asarray(
            _flow_list(fields["data"]), dtype=np.float64
        ).reshape(int(fields["rows"]), int(fields["cols"]))
    return out


@dataclasses.dataclass
class Settings:
    camera: Camera
    camera2: Optional[Camera]  # right camera for stereo, else None
    sensor_type: str  # inferred default; overridden by System ctor arg
    fps: float
    rgb: bool
    # stereo
    T_c1_c2: Optional[np.ndarray]  # (4, 4)
    stereo_b: float
    stereo_th_depth: float
    # ORB extractor
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: int
    min_th_fast: int
    # IMU
    T_b_c1: Optional[np.ndarray]  # (4, 4)
    noise_gyro: float
    noise_acc: float
    gyro_walk: float
    acc_walk: float
    imu_frequency: float
    insert_kfs_when_lost: bool
    # system
    loop_closing: bool
    save_atlas_to_file: Optional[str]
    load_atlas_from_file: Optional[str]
    th_far_points: float
    raw: Dict


def _cam_from(d: Dict, prefix: str, cam_type: str, width: int, height: int,
              fps: float, baseline: float) -> Optional[Camera]:
    fx = d.get(f"{prefix}.fx", d.get("Camera.fx"))
    if fx is None:
        return None
    fy = d.get(f"{prefix}.fy", d.get("Camera.fy"))
    cx = d.get(f"{prefix}.cx", d.get("Camera.cx"))
    cy = d.get(f"{prefix}.cy", d.get("Camera.cy"))
    if cam_type == "KannalaBrandt8":
        dist = [d.get(f"{prefix}.k{i}", 0.0) for i in (1, 2, 3, 4)]
    elif cam_type == "PinHole":
        dist = [
            d.get(f"{prefix}.k1", 0.0), d.get(f"{prefix}.k2", 0.0),
            d.get(f"{prefix}.p1", 0.0), d.get(f"{prefix}.p2", 0.0),
            d.get(f"{prefix}.k3", 0.0),
        ]
    else:  # Rectified
        dist = []
    return make_camera(
        cam_type if cam_type != "Rectified" else "Rectified",
        fx, fy, cx, cy, dist, width, height, fps, baseline,
    )


def load_settings(path: str) -> Settings:
    d = load_opencv_yaml(path)
    cam_type = d.get("Camera.type", "PinHole")
    width = int(d.get("Camera.newWidth", d.get("Camera.width", 640)))
    height = int(d.get("Camera.newHeight", d.get("Camera.height", 480)))
    orig_w = int(d.get("Camera.width", width))
    orig_h = int(d.get("Camera.height", height))
    fps = float(d.get("Camera.fps", 30.0))
    baseline = float(d.get("Stereo.b", 0.0))

    cam1 = _cam_from(d, "Camera1", cam_type, orig_w, orig_h, fps, baseline)
    cam2 = _cam_from(d, "Camera2", cam_type, orig_w, orig_h, fps, baseline)
    if cam1 is None:
        raise ValueError(f"no camera intrinsics found in {path}")
    # image resize (Camera.newWidth/newHeight — reference rescales intrinsics)
    if (width, height) != (orig_w, orig_h):
        sx = width / orig_w
        sy = height / orig_h

        def rescale(c: Camera) -> Camera:
            return make_camera(
                {0: "PinHole", 1: "Rectified", 2: "KannalaBrandt8"}[int(c.model)],
                c.fx * sx, c.fy * sy, c.cx * sx, c.cy * sy,
                c.params[4:], width, height, fps, baseline,
            )

        cam1 = rescale(cam1)
        cam2 = rescale(cam2) if cam2 is not None else None

    has_imu = "IMU.NoiseGyro" in d
    sensor = "STEREO" if cam2 is not None or baseline > 0 else "MONOCULAR"
    if has_imu:
        sensor = "IMU_" + sensor

    return Settings(
        camera=cam1,
        camera2=cam2,
        sensor_type=sensor,
        fps=fps,
        rgb=bool(d.get("Camera.RGB", 1)),
        T_c1_c2=d.get("Stereo.T_c1_c2"),
        stereo_b=baseline,
        stereo_th_depth=float(d.get("Stereo.ThDepth", 60.0)),
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        T_b_c1=d.get("IMU.T_b_c1"),
        noise_gyro=float(d.get("IMU.NoiseGyro", 1.7e-4)),
        noise_acc=float(d.get("IMU.NoiseAcc", 2.0e-3)),
        gyro_walk=float(d.get("IMU.GyroWalk", 1.9e-5)),
        acc_walk=float(d.get("IMU.AccWalk", 3.0e-3)),
        imu_frequency=float(d.get("IMU.Frequency", 200.0)),
        insert_kfs_when_lost=bool(d.get("IMU.InsertKFsWhenLost", 0)),
        loop_closing=bool(d.get("loopClosing", 1)),
        save_atlas_to_file=d.get("System.SaveAtlasToFile"),
        load_atlas_from_file=d.get("System.LoadAtlasFromFile"),
        th_far_points=float(d.get("System.thFarPoints", 0.0)),
        raw=d,
    )
