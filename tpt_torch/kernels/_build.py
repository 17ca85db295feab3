"""Build and load the CUDA kernel libraries of tpt_torch/csrc at first use.

A library is one ``csrc/*.cu`` source compiled by its own ``nvcc`` process
into a shared library with a plain C interface, loaded with ctypes.  It is
built either dynamic (``counts=None``), its kernels reading the scene's
counts at run time, or for ``(n_spheres, n_cuboids)`` with
``-DTPT_NUM_SPHERES`` and ``-DTPT_NUM_CUBOIDS`` (csrc/common.cuh), as tpt's
accelerator path compiles its trace kernels for a scene's static counts.
A library goes into ``tpt_torch/_build/<hash>/``, keyed by a hash of the
flags, its source and every ``csrc/*.cuh`` header, so an edited source or
header rebuilds and an unchanged one loads at once.  Nothing is built when
the module is imported: the CPU tests import every module.

:func:`library` gives one library's entry points, built at its first use;
each wrapper loads only the libraries it launches, and
tpt_torch.kernels.trace.forward_key decides which launches take a build
for counts.  :func:`build_all` builds any number of libraries with
one nvcc process per missing one, all started together.  Each library's
compiler output, ptxas's report and the build's seconds included, is kept
beside it as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import types
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from ..config import MAX_CUBOIDS, MAX_SPHERES

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false and no --use_fast_math: the parity policy of csrc/common.cuh.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
MAX_COLS = 32   # csrc/probes.cu kMaxCols
SECONDS_LINE = "# nvcc seconds: "   # the build's wall time, the last line of a .log

Key = Optional[Tuple[int, int]]   # a library's counts: None, or (n_spheres, n_cuboids)


class ColWeights(ctypes.Structure):
    """The scatter probes' column weights a, c (csrc/probes.cu ColWeights,
    whose size ``tpt_probe_scatter_layout`` gives to check this one);
    ``tpt_probe_scatter`` takes its address and copies it into the launch."""
    _fields_ = [("a", ctypes.c_float * MAX_COLS), ("c", ctypes.c_float * MAX_COLS)]


# entry point -> (source file, argument types); every entry returns a CUDA error code
ENTRY_POINTS = {
    # 5 scene pointers, 2 counts, the host camera pointer, 11 ints,
    # 5 output pointers, the stream
    "tpt_trace_progressive": ("trace.cu", [_P] * 5 + [_I] * 2 + [_P] + [_I] * 11 + [_P] * 5 + [_P]),
    # 5 scene pointers, 2 counts, the host camera pointer, 11 ints, the
    # environment table and its face size, 3 output pointers, the warp
    # iterations' pointer (may be null), the stream
    "tpt_trace_progressive_env": ("trace.cu", [_P] * 5 + [_I] * 2 + [_P] + [_I] * 11 + [_P, _I]
                                  + [_P] * 4 + [_P]),
    # the same, the environment table in its bf16 form
    "tpt_trace_progressive_env_bf16": ("trace.cu", [_P] * 5 + [_I] * 2 + [_P] + [_I] * 11
                                       + [_P, _I] + [_P] * 4 + [_P]),
    # 3 geometry pointers, the table, 2 counts, the host camera pointer,
    # 9 ints, 5 output pointers, the stream
    "tpt_trace_onehot": ("trace.cu", [_P] * 4 + [_I] * 2 + [_P] + [_I] * 9 + [_P] * 5 + [_P]),
    # out: blocks per SM of the select, table, environment and bf16-environment
    # kernels (no launch)
    "tpt_trace_layout": ("trace.cu", [_P]),
    # 4 scene/table pointers, 2 counts, the device cam20 pointer, 11 ints
    # (the last the ablate flags), the tape's 3 pointers, the stream
    "tpt_trace_grad_tape": ("trace_grad.cu", [_P] * 4 + [_I] * 2 + [_P] + [_I] * 11 + [_P] * 3
                            + [_P]),
    # out: the tape kernel's blocks per SM (no launch)
    "tpt_trace_grad_tape_layout": ("trace_grad.cu", [_P]),
    # the table, 2 counts, the device cam20 pointer, 11 ints (the last the
    # ablate flags), the tape's 3 pointers, 3 cotangent pointers, their
    # channel stride, first_chunk, last_chunk, grid, the workspace, the
    # output, the stream
    "tpt_trace_grad_adjoint": ("trace_grad_adjoint.cu", [_P] + [_I] * 2 + [_P] + [_I] * 11
                               + [_P] * 6 + [_L] + [_I] * 3 + [_P] * 2 + [_P]),
    # out: the workspace's f32 words, the blocks per SM, the grid (no launch)
    "tpt_trace_grad_adjoint_layout": ("trace_grad_adjoint.cu", [_P] * 3),
    # idx, table, cols, col, n, out, the stream
    "tpt_probe_gather": ("probes.cu", [_P, _P, _I, _I, _L, _P, _P]),
    # idx, g (16-byte aligned), the window first, n (multiples of 4), the
    # host ColWeights, rows, cols, the (device, stream)'s workspace (no
    # zeroing per call), d, the stream
    "tpt_probe_scatter": ("probes.cu", [_P, _P, _L, _L, _P, _I, _I, _P, _P, _P]),
    # out: the workspace's 32-bit words, the bytes of a ColWeights (no launch)
    "tpt_probe_scatter_layout": ("probes.cu", [_P, _P]),
    # x, g, n (a multiple of 4), mode, out (all 16-byte aligned), the stream
    "tpt_probe_elementwise": ("probes.cu", [_P, _P, _L, _I, _P, _P]),
}


SOURCES = tuple(sorted({src for src, _ in ENTRY_POINTS.values()}))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return nvcc


def build_key(counts=None) -> Key:
    """The key of the build that serves ``counts``: None (the dynamic
    build) for ``counts=None``, else ``(n_spheres, n_cuboids)``.
    ValueError for counts outside the scene's tables."""
    if counts is None:
        return None
    ns, nc = (int(c) for c in counts)
    if not (0 <= ns <= MAX_SPHERES and 0 <= nc <= MAX_CUBOIDS):
        raise ValueError(f"counts out of range: {(ns, nc)}")
    return ns, nc


def define_flags(key: Key) -> Tuple[str, ...]:
    """The -D flags of a build (none for the dynamic one)."""
    return () if key is None else (f"-DTPT_NUM_SPHERES={key[0]}", f"-DTPT_NUM_CUBOIDS={key[1]}")


def library_path(source: str, counts=None) -> Path:
    """Where ``source``'s library for ``counts`` goes (ValueError for a
    source that is not in csrc or counts out of range)."""
    key = build_key(counts)
    if source not in SOURCES:
        raise ValueError(f"csrc holds {SOURCES}, not {source}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS + define_flags(key)).encode())
    for path in [SRC_DIR / source] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{Path(source).stem}.so"


def build_seconds(path: Path) -> Optional[float]:
    """The wall seconds of the nvcc run that built the library at ``path``,
    from its .log (None when the log has no such line)."""
    log = path.with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    if lines and lines[-1].startswith(SECONDS_LINE):
        return float(lines[-1][len(SECONDS_LINE):])
    return None


def build_all(libraries: Iterable[tuple]) -> Dict[Tuple[str, Key], Tuple[Path, str]]:
    """Compile every library of ``libraries``, (source, counts) pairs, that
    is not built yet, one nvcc process per library, all started together;
    every pair is checked before any nvcc runs.  Returns {(source,
    :func:`build_key` of its counts): (path, compiler output, ptxas's
    report included)}; the output of a library built before is read from
    the ``.log`` file kept beside it.  nvcc writes its output to a
    temporary log, which gets the build's seconds as its last line; the log
    and then the library are renamed into place, so concurrent builds
    (ranks, test workers) never load a partial file.  A failed build
    raises; nothing falls back."""
    paths = {(src, build_key(counts)): library_path(src, counts) for src, counts in libraries}
    jobs = []
    try:
        for (src, key), path in paths.items():
            if path.exists():
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            fd, tmp_log = tempfile.mkstemp(suffix=".log", dir=path.parent)
            cmd = [find_nvcc(), *NVCC_FLAGS, *define_flags(key), "-o", tmp, str(SRC_DIR / src)]
            with os.fdopen(fd, "w") as log:
                proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            jobs.append(dict(key=key, src=src, path=path, tmp=tmp, log=tmp_log, proc=proc,
                             t0=time.perf_counter(), seconds=None))
        while any(job["seconds"] is None for job in jobs):
            for job in jobs:
                if job["seconds"] is None and job["proc"].poll() is not None:
                    job["seconds"] = time.perf_counter() - job["t0"]
            time.sleep(0.05)
        for job in jobs:
            out = Path(job["log"]).read_text()
            if job["proc"].returncode != 0:
                raise RuntimeError(f"nvcc {job['src']} {' '.join(define_flags(job['key']))} "
                                   f"failed ({job['proc'].returncode}):\n{out}")
            with open(job["log"], "a") as log:
                sep = "" if not out or out.endswith("\n") else "\n"
                log.write(f"{sep}{SECONDS_LINE}{job['seconds']:.2f}\n")
            os.replace(job["log"], job["path"].with_suffix(".log"))
            os.replace(job["tmp"], job["path"])
    finally:
        for job in jobs:
            if job["proc"].poll() is None:
                job["proc"].kill()
                job["proc"].wait()
            for f in (job["tmp"], job["log"]):
                if os.path.exists(f):
                    os.unlink(f)
    return {pair: (path, path.with_suffix(".log").read_text()
                   if path.with_suffix(".log").exists() else "")
            for pair, path in paths.items()}


def library(source: str, counts=None) -> types.SimpleNamespace:
    """The library of ``source`` for ``counts``, built at first use and
    loaded once: its entry points with their signatures set, and
    ``source``, ``key`` (:func:`build_key`), ``path`` and ``log`` (the
    compiler output, ptxas's report included), as attributes of one
    namespace."""
    return _load(source, build_key(counts))


@functools.lru_cache(maxsize=None)
def _load(source: str, key: Key) -> types.SimpleNamespace:
    path, log = build_all([(source, key)])[source, key]
    lib = ctypes.CDLL(str(path))
    fns = {}
    for name, (src, argtypes) in ENTRY_POINTS.items():
        if src == source:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(source=source, key=key, path=path, log=log, **fns)
