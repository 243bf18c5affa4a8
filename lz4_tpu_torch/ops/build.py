"""Build the port's CUDA kernels and load them with ctypes.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
build runs at first use, into `build/lz4_tpu_torch/` at the root of the
checkout, keyed by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags: a changed source or header builds anew, an
unchanged one is loaded as it is.  The compiler's
`-Xptxas -v` report (registers, shared memory, spills per kernel) is kept
beside each library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().with_name("csrc")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lz4_tpu_torch"
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("decode", "encode_stream", "decode_stream", "xxh32", "encode_opt",
                  "encode_hc_passes", "encode_continue", "ubench")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    digest = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    key = digest.hexdigest()[:16]
    return _BUILD_DIR / f"{name}-{key}.so"


def build(*names: str) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together.  Returns each source's
    `-Xptxas -v` report."""
    pending = []
    for name in names:
        lib = _library(name)
        if lib.exists() and lib.with_suffix(".log").exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending.append((name, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in pending:  # wait for every process first
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {n: _library(n).with_suffix(".log").read_text() for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(_library(name)))
            _LIBS[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
