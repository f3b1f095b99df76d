"""Build hand-written CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` exposes a plain C entry point.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root (listed in ``.gitignore``) and loaded with ``ctypes``.  The library's
file name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  The compiler's output
(registers, spills) is kept beside the library as ``.log``.

:func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together; :func:`load` builds a single missing source;
:func:`launch` calls an entry point on a device's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Sequence

import torch

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


def build(sources: Sequence[Path]) -> Dict[Path, float]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all running at once.  Returns each compiled source's build time in
    seconds (from the common start to its process's exit).  Raises, with
    the compiler's output, if any build fails."""
    started = {}
    t0 = time.perf_counter()
    for source in map(Path, sources):
        path = library_path(source)
        if path.exists() or source in started:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = path.with_suffix(".log")
        with open(log, "w") as out:
            proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                     str(source)], stdout=out,
                                    stderr=subprocess.STDOUT)
        started[source] = (proc, tmp, path, log)
    times: Dict[Path, float] = {}
    failed = []
    pending = dict(started)
    while pending:
        for source, (proc, tmp, path, log) in list(pending.items()):
            rc = proc.poll()
            if rc is None:
                continue
            times[source] = time.perf_counter() - t0
            del pending[source]
            if rc:
                failed.append(f"CUDA build of {source.name} failed (nvcc exit "
                              f"{rc}):\n{log.read_text()}")
            else:
                os.replace(tmp, path)
        if pending:
            time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, compiled first if it is missing.
    Raises if ``nvcc`` fails."""
    source = Path(source)
    lib = _LOADED.get(source)
    if lib is not None:
        return lib
    build([source])
    lib = _LOADED[source] = ctypes.CDLL(str(library_path(source)))
    return lib


def launch(fn: Any, device: torch.device, *args: Any) -> int:
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream (switching the current device only when it differs) and return
    its CUDA error code."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)
