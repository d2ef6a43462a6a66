"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/<name>-<hash>.so`` at
the repository root, then loaded with ``ctypes``.  The file name carries a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one loads the library already built.  Nothing is built when a
module is imported: a wrapper loads its library at its first CUDA call, and
``build_all`` compiles every source at once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

# -fmad=false: every product and sum rounds on its own, as in the plain
# PyTorch versions the kernels are checked against
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (target, process or None)."""
    out = _target(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    out.with_suffix(".log").write_text(log)
    return log


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> dict:
    """Compile every kernel source in parallel; returns {name: nvcc log}
    (empty for a library that was already built)."""
    with _lock:
        jobs = {n: _start(n) for n in sources()}
        return {n: _finish(n, out, job) for n, (out, job) in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _start(name)
            _finish(name, out, job)
            lib = ctypes.CDLL(str(out))
            lib.cg_error_string.restype = ctypes.c_char_p
            lib.cg_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.cg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
