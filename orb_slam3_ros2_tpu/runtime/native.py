"""The native host library (native/feeder.cpp + native/pcl_filters.cpp).

It is built from the sources in `native/` with `make -C native`, either by
that command or here on first use; the build output is not versioned.
Callers fall back to their pure-Python paths when no C++ compiler is
available (`load()` returns None).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess
from typing import Optional

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libslam_native.so")


def build() -> bool:
    """Run `make -C native` unless the library exists. A file lock keeps
    concurrent first uses (test workers, processes of one session) from
    racing on the output. Returns whether the library exists afterwards."""
    if os.path.exists(LIB_PATH):
        return True
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(LIB_PATH):
            try:
                subprocess.run(["make", "-s", "-C", NATIVE_DIR], check=True,
                               capture_output=True, timeout=300)
            except (OSError, subprocess.SubprocessError):
                return False
    return os.path.exists(LIB_PATH)


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it first if needed; None when it can
    be neither found nor built."""
    if not build():
        return None
    try:
        return ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
