"""Build the port's CUDA C++ kernels with ``nvcc`` and load them with ``ctypes``.

Each ``vface_torch/csrc/<name>.cu`` exports plain C functions and is compiled
on first use into ``build/vface_torch/lib<name>-<digest>.so`` at the root of
the checkout (``<digest>`` hashes the source and the flags, so an edited source
is rebuilt). Nothing here runs at import time: this module only imports the
standard library.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vface_torch"
SOURCES = ("flash_attention", "flash_attention_bwd", "geglu_ff")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("vface_torch: nvcc not found (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library among ``names``, one ``nvcc`` each, all at once.

    Returns {name: compiler log (ptxas register and spill report)}; raises with
    the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        logs[name] = log
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("vface_torch: nvcc failed\n" + "\n".join(failed))
    return logs


def function(lib: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``lib``, built and loaded on first use.

    Every pointer and the stream must be declared ``c_void_p``; the function
    returns ``cudaGetLastError()`` as an int.
    """
    with _lock:
        if lib not in _libs:
            build([lib])
            _libs[lib] = ctypes.CDLL(str(lib_path(lib)))
        fn = getattr(_libs[lib], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"vface_torch: {what} launch failed with CUDA error {err}")
