"""Build and load the port's CUDA kernels, and check their arguments.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), then loaded with
``ctypes``.  A library's file name carries a hash of its source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or
header is rebuilt and a current one is reused.
``build_all`` starts one ``nvcc`` per missing library, all at once, and
waits for every one of them.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("megastep", "rowslab", "scan", "conflict", "admit",
           "admit_ops", "flash_attention", "flash_attention_bwd", "wkv",
           "wkv_bwd")
# sm_90a: Hopper.  --fmad=false: no multiply-add contraction anywhere, so
# float results are the plain versions' to the bit.
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under
    ``CUDA_HOME``, else the toolkit's default install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def target(name: str, csrc: Path = CSRC):
    """(source, library path) of one kernel library.  The path's hash
    covers the source, every header of ``csrc`` (``*.cuh``, which a
    source may include) and the flags, so an edited header rebuilds the
    libraries too."""
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return src, BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every kernel library of ``names`` that is not built yet,
    one ``nvcc`` process per source, all started together.  Returns
    ``{name: compiler output}`` (``-Xptxas -v``: registers, shared
    memory and spills per kernel) for the libraries it built; raises if
    any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, out = target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, out = target(name)
            if not out.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib


def check_arg(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel's wrapper checks before passing a pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")
