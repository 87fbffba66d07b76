"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` compiles, all at once and each in its own ``nvcc``, for
``sm_90a``, and the objects link into one shared library with a plain C
interface under ``build/kernels/`` at the repository root.  The library's
name carries a hash of the sources and flags, so an edit rebuilds and an
unchanged tree reuses the library.  The build happens at first use, never
at import.  No ``--use_fast_math``: NaN propagation and the ``==``/``>``
compares of the kernels must stay IEEE.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels need the "
                           "CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library.

    ``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libreprotorch_{source_hash()}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_star_gather_launch.argtypes = [
        vp, vp, i32, i64, ctypes.POINTER(vp), ctypes.POINTER(i32), i32, vp,
        vp, vp]
    lib.fused_star_gather_launch.restype = i32
    lib.tree_predict_launch.argtypes = [vp, vp, vp, vp, vp, vp, i64, i32,
                                        i32, i32, vp, vp, vp]
    lib.tree_predict_launch.restype = i32
    lib.tree_predict_smem_bytes.argtypes = [i32, i32, i32]
    lib.tree_predict_smem_bytes.restype = i64
    lib.tree_predict_scratch_bytes.argtypes = [i32, i32]
    lib.tree_predict_scratch_bytes.restype = i64
    lib.onehot_matmul_launch.argtypes = [vp, i64, vp, i32, i32, i32, vp, vp,
                                         vp, vp]
    lib.onehot_matmul_launch.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launch entry point returned a CUDA error code."""
    if status != 0:
        msg = load().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
