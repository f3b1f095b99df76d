"""Build hand-written CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` exposes a plain C entry point.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root (listed in ``.gitignore``) and loaded with ``ctypes``.  The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  The compiler's output
(registers, spills) is kept beside the library as ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit (``$CUDA_HOME``, ``/usr/local/cuda`` or
    the ``PATH``)."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha1(Path(source).read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if it is missing.
    Raises if ``nvcc`` fails."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is not None:
        return lib
    path = library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = path.with_suffix(".log")
        with open(log, "w") as out:
            rc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(source)], stdout=out,
                                stderr=subprocess.STDOUT).returncode
        if rc:
            raise RuntimeError(f"CUDA build of {source.name} failed (nvcc "
                               f"exit {rc}):\n{log.read_text()}")
        os.replace(tmp, path)
    lib = _LOADED[source] = ctypes.CDLL(str(path))
    return lib
