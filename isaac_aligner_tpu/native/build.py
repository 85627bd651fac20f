"""Build-on-first-use for the native components (g++ -> .so, ctypes).

The package ships C++ sources and needs only g++ at run time: the small
sources compile into shared objects next to this file, cached by source mtime
and rebuilt when a cached object fails to load.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_DIR = Path(__file__).parent
_CACHE: dict[str, ctypes.CDLL | None] = {}

_LINK_FLAGS = {
    "bgzf": ["-lz", "-lpthread"],
    "bamrec": ["-lpthread"],
    "fastq": ["-lpthread"],
}


def _compile(name: str, src: Path, so: Path) -> None:
    """g++ the source into `so` (written aside, then renamed, so a
    concurrent loader never maps a half-written file)."""
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           str(src), "-o", str(tmp)] + _LINK_FLAGS.get(name, [])
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, so)


def load_library(name: str) -> ctypes.CDLL | None:
    """Compile (if stale) and load lib<name>.so; None if build fails.

    A library that exists but does not load (built against another
    host's C++ runtime, or truncated) is rebuilt from the source once."""
    if name in _CACHE:
        return _CACHE[name]
    src = _DIR / f"{name}.cpp"
    so = _DIR / f"lib{name}.so"
    lib: ctypes.CDLL | None = None
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            _compile(name, src, so)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            _compile(name, src, so)
            lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        lib = None
    _CACHE[name] = lib
    return lib
