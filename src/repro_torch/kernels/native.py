"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface and loaded with ``ctypes``.  No PyTorch header is included, so
the whole build takes seconds.  The library lands in ``_build/`` beside this
file (listed in ``.gitignore``), named by a hash of the sources and flags,
so a changed source is rebuilt and an unchanged one is reused.

Nothing is built at import time: :func:`library` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("pareto_filter.cu", "mogd_descend.cu", "compose.cu", "mogd_mlp.cu",
           "rwkv6_wkv.cu", "flash_attention.cu", "mamba_scan.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# No --use_fast_math: expf/cosf/powf/sqrtf and division stay IEEE, and
# -fmad=false keeps elementwise a*b+c rounded twice, as PyTorch's separate
# elementwise kernels round it; products inside the dots use fmaf().
CFLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_REPORT: str = ""

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def nvcc_path() -> str:
    """The ``nvcc`` to build with (``PATH`` first, then the toolkit)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (in parallel) and link the shared library.

    Returns the library's path; reuses an existing build of the same
    sources.  Raises ``RuntimeError`` with the compiler's output when a
    source does not compile."""
    global _REPORT
    so = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    log = so.with_suffix(".log")
    if so.exists():
        _REPORT = log.read_text() if log.exists() else ""
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (Path(name).stem + ".o")
            cmd = [nvcc, *CFLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs, objs, failed = [], [], []
        for name, obj, p in procs:
            out, _ = p.communicate()
            outputs.append(f"== {name}\n{out}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(name)
        report = "\n".join(outputs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
        part = tmp / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(part), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        log.write_text(report)
        os.replace(part, so)
        _REPORT = report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def ptxas_report() -> str:
    """What ``ptxas -v`` said about each kernel in the last build."""
    return _REPORT


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.pareto_cross_dominator_counts.argtypes = [
                ctypes.c_char_p, _VP]  # pareto_filter._pack
            lib.pareto_cross_dominator_counts.restype = _I
            lib.mogd_descend.argtypes = [
                _VP, _VP, _VP, _VP, _VP, _VP, _VP,  # x0 + row constants
                _VP, _LL, _VP,  # weights, group stride, plan
                _I, _I, _I, _I,  # G, Mp, D, block rows
                _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,  # hyperparameters
                _I, _VP, _VP]  # smem bytes, out, stream
            lib.mogd_descend.restype = _I
            lib.mogd_descend_resident.argtypes = [
                _VP, _VP, _VP, _VP, _VP, _VP, _VP,  # x0 + row constants
                _VP, _VP,  # weight blocks, resident plan
                _I, _I, _I, _I,  # G, Mp, D, block rows
                _I, _F, _F, _F, _F, _F, _F, _F, _F, _F,  # hyperparameters
                _I, _VP, _VP]  # smem bytes, out, stream
            lib.mogd_descend_resident.restype = _I
            lib.pairwise_compose.argtypes = [ctypes.c_char_p, _VP]  # compose._pack
            lib.pairwise_compose.restype = _I
            lib.mlp_forward.argtypes = [ctypes.c_char_p, _VP]  # mogd_mlp._pack
            lib.mlp_forward.restype = _I
            lib.rwkv6_wkv.argtypes = [ctypes.c_char_p, _VP]  # rwkv6_wkv._pack
            lib.rwkv6_wkv.restype = _I
            lib.flash_attention_fwd.argtypes = [
                _VP, _VP, _VP, _VP,  # q k v o
                _I, _I, _I, _I, _I, _I, _F, _I, _VP]  # B S H Hk dh bf16 ...
            lib.flash_attention_fwd.restype = _I
            lib.mamba_scan.argtypes = [ctypes.c_char_p, _VP]  # mamba_scan._pack
            lib.mamba_scan.restype = _I
            lib.mogd_plan_bytes.argtypes = []
            lib.mogd_plan_bytes.restype = _I
            lib.mogd_resident_plan_bytes.argtypes = []
            lib.mogd_resident_plan_bytes.restype = _I
            lib.repro_cuda_error_string.argtypes = [_I]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
