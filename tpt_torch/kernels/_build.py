"""Build and load the CUDA kernel libraries of tpt_torch/csrc at first use.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a
shared library with a plain C interface; the processes run in parallel and
the libraries are loaded with ctypes.  A library goes into
``tpt_torch/_build/<hash>/``, keyed by a hash of the flags, its source and
every ``csrc/*.cuh`` header, so an edited source or header rebuilds and an
unchanged one loads at once.  Nothing is built when the module is imported:
the CPU tests import every module.

Library sets.  The dynamic set (key ``None``) holds every source, its
kernels reading the scene's counts at run time.  A specialised set, key
``(n_spheres, n_cuboids, unroll)`` (:func:`build_key`), holds the two
sources whose kernels fold the closest-hit scan, ``trace.cu`` and
``trace_grad.cu``, built with ``-DTPT_NUM_SPHERES``, ``-DTPT_NUM_CUBOIDS``
and ``-DTPT_UNROLL`` (csrc/common.cuh), as tpt's accelerator path compiles
its trace kernels for a scene's static counts; those flags enter the hash,
so each key has its own libraries.  ``unroll`` defaults to ``UNROLL``, the
form a path's launch takes (tpt_torch.kernels.trace says which launches
take a specialised set); the other form is built only to be compared.
:func:`build_all` builds any number of sets with one nvcc process per
missing library, all started together.  Each library's compiler output,
ptxas's report and the build's seconds included, is kept beside it as
``.log``.
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

# the sources whose kernels fold the scan, the only ones a specialised set holds
SPECIALISED_SOURCES = ("trace.cu", "trace_grad.cu")
UNROLLS = (0, 1)   # rolled at the constant bound, or fully unrolled
# the form of the specialised sets a path launches: rolled, which beat the
# full unroll (and the dynamic set on the 1080p block) on the H100
# (PERF.md section 6, the static-count builds)
UNROLL = 0
SECONDS_LINE = "# nvcc seconds: "   # the build's wall time, the last line of a .log

Key = Optional[Tuple[int, int, int]]   # None, or (n_spheres, n_cuboids, unroll)


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


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")
    return nvcc


def build_key(counts=None, unroll: int = UNROLL) -> Key:
    """The key of the library set that serves ``counts`` and ``unroll``:
    None (the dynamic set) for ``counts=None``, else ``(n_spheres,
    n_cuboids, unroll)``.  ValueError for an ``unroll`` outside {0, 1} or
    counts outside the scene's tables."""
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be 0 (rolled) or 1 (fully unrolled), got {unroll!r}")
    if counts is None:
        return None
    ns, nc = (int(c) for c in counts)
    if not (0 <= ns <= MAX_SPHERES and 0 <= nc <= MAX_CUBOIDS):
        raise ValueError(f"counts out of range: {(ns, nc)}")
    return ns, nc, int(unroll)


def define_flags(key: Key) -> Tuple[str, ...]:
    """The -D flags of a set's build (none for the dynamic set)."""
    if key is None:
        return ()
    ns, nc, unroll = key
    return (f"-DTPT_NUM_SPHERES={ns}", f"-DTPT_NUM_CUBOIDS={nc}", f"-DTPT_UNROLL={unroll}")


def _sources(key: Key = None):
    sources = sorted({src for src, _ in ENTRY_POINTS.values()})
    return sources if key is None else [s for s in sources if s in SPECIALISED_SOURCES]


def _library_path(source: str, key: Key) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + define_flags(key)).encode())
    for path in [SRC_DIR / source] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{Path(source).stem}.so"


def library_path(source: str, counts=None, unroll: int = UNROLL) -> Path:
    """Where ``source``'s library of the set for ``counts`` and ``unroll``
    goes (ValueError for a source a specialised set does not hold)."""
    key = build_key(counts, unroll)
    if source not in _sources(key):
        raise ValueError(f"the set {key} holds {_sources(key)}, not {source}")
    return _library_path(source, key)


def build_seconds(path: Path) -> Optional[float]:
    """The wall seconds of the nvcc run that built the library at ``path``,
    from its .log (None when the log has no such line)."""
    log = path.with_suffix(".log")
    lines = log.read_text().splitlines() if log.exists() else []
    if lines and lines[-1].startswith(SECONDS_LINE):
        return float(lines[-1][len(SECONDS_LINE):])
    return None


def build_all(keys: Iterable[Key]) -> Dict[Key, Tuple[Dict[str, Path], str]]:
    """Compile every library of the sets ``keys`` (:func:`build_key`
    values) that is not built yet, one nvcc process per library, all
    started together.  Returns {key: ({source: path}, compiler output of
    every library of the set, ptxas's report included)}; the output of a
    library built before is read from the ``.log`` file kept beside it.
    nvcc writes its output to a temporary log, which gets the build's
    seconds as its last line; the log and then the library are renamed
    into place, so concurrent builds (ranks, test workers) never load a
    partial file.  A failed build raises; nothing falls back."""
    sets = {key: {src: _library_path(src, key) for src in _sources(key)}
            for key in dict.fromkeys(keys)}
    jobs = []
    try:
        for key, paths in sets.items():
            for src, path in paths.items():
                if path.exists():
                    continue
                path.parent.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
                os.close(fd)
                fd, tmp_log = tempfile.mkstemp(suffix=".log", dir=path.parent)
                cmd = [find_nvcc(), *NVCC_FLAGS, *define_flags(key), "-o", tmp,
                       str(SRC_DIR / src)]
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
    return {key: (paths, "".join(f"== {src}\n{path.with_suffix('.log').read_text()}"
                                 for src, path in paths.items()
                                 if path.with_suffix(".log").exists()))
            for key, paths in sets.items()}


def ensure_built(counts=None, unroll: int = UNROLL) -> Tuple[Dict[str, Path], str]:
    """The one set for ``counts`` and ``unroll`` (:func:`build_all`):
    ({source: path}, compiler output of every library of the set)."""
    key = build_key(counts, unroll)
    return build_all([key])[key]


def load_library(counts=None, unroll: int = UNROLL) -> types.SimpleNamespace:
    """The entry points of the set for ``counts`` and ``unroll``, built at
    first use, with their signatures set, as attributes of one namespace:
    every entry for the dynamic set, those of trace.cu and trace_grad.cu
    for a specialised one.  Loaded once per key."""
    return _load(build_key(counts, unroll))


@functools.lru_cache(maxsize=None)
def _load(key: Key) -> types.SimpleNamespace:
    paths, _ = build_all([key])[key]
    libs = {src: ctypes.CDLL(str(path)) for src, path in paths.items()}
    fns = {}
    for name, (src, argtypes) in ENTRY_POINTS.items():
        if src not in libs:
            continue
        fn = getattr(libs[src], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(key=key, libraries=libs, **fns)
