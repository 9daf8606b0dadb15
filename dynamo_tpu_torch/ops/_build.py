"""Build and load the port's CUDA kernels (``dynamo_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. Libraries are built at first use into
``dynamo_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the source and the ``csrc`` headers it includes, so a changed source or
header rebuilds and an unchanged one loads the library already there.
``build()`` starts one ``nvcc`` per missing source, all at once, and
waits for them together.

Nothing here runs at import time: the module imports on a machine without
``nvcc`` (the CPU tests), and only a kernel launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# kernel name → source file under csrc/
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "paged_flash": "paged_flash.cu",
    "paged_verify": "paged_verify.cu",
    "sampling_epilogue": "sampling_epilogue.cu",
    "mla_decode": "mla_decode.cu",
    "sp_prefix": "sp_prefix.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
# per kernel: seconds its build took in this process (0.0 = loaded from
# an earlier build) and nvcc's output (the -Xptxas=-v register/spill report)
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and every file under ``CSRC`` it includes with quotes,
    recursively, each once, in include order."""
    if path in seen:
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        dep = path.parent / inc.decode()
        if dep.exists():
            _sources(dep, seen)
    return seen


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, the
    headers it includes and the flags: an edited header rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(CSRC / SOURCES[name], []):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns seconds per kernel
    (0.0 for one already built). Raises with nvcc's output on failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.monotonic()
    for name in names:
        out = library_path(name)
        if out.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        build_seconds[name] = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: build_seconds[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a C entry."""
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA launch failed with cudaError {rc}"
        )
