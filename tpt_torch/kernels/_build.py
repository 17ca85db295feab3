"""Build and load the CUDA kernel libraries of tpt_torch/csrc at first use.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a
shared library with a plain C interface; the processes run in parallel and
the libraries are loaded with ctypes.  A library goes into
``tpt_torch/_build/<hash>/``, keyed by a hash of the flags, its source and
every ``csrc/*.cuh`` header, so an edited source or header rebuilds and an
unchanged one loads at once.  Nothing is built when the module is imported:
the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false and no --use_fast_math: the parity policy of csrc/common.cuh.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
MAX_COLS = 32   # csrc/probes.cu kMaxCols


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
    # environment table and its face size, 3 output pointers, the stream
    "tpt_trace_progressive_env": ("trace.cu", [_P] * 5 + [_I] * 2 + [_P] + [_I] * 11 + [_P, _I]
                                  + [_P] * 3 + [_P]),
    # the same, the environment table in its bf16 form
    "tpt_trace_progressive_env_bf16": ("trace.cu", [_P] * 5 + [_I] * 2 + [_P] + [_I] * 11
                                       + [_P, _I] + [_P] * 3 + [_P]),
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


def _sources():
    return sorted({src for src, _ in ENTRY_POINTS.values()})


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [SRC_DIR / source] + sorted(SRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / f"lib{Path(source).stem}.so"


def ensure_built() -> Tuple[Dict[str, Path], str]:
    """Compile every library whose hash is not built yet, one nvcc process
    per source, all started together.  Returns ({source: path}, compiler
    output of every library, ptxas's report included); the output of a
    library built before is read from the ``.log`` file kept beside it.
    Each library is written to a temporary name and renamed into place
    after its log, so concurrent builds never load a partial file."""
    paths = {src: library_path(src) for src in _sources()}
    jobs = []
    try:
        for src, path in paths.items():
            if path.exists():
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / src)]
            jobs.append((src, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for src, path, tmp, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {src} failed ({proc.returncode}):\n{out}")
            path.with_suffix(".log").write_text(out)
            os.replace(tmp, path)
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    log = [f"== {src}\n{path.with_suffix('.log').read_text()}" for src, path in paths.items()
           if path.with_suffix(".log").exists()]
    return paths, "".join(log)


@functools.lru_cache(maxsize=None)
def load_library() -> types.SimpleNamespace:
    """The entry points of the built libraries, with their signatures set,
    as attributes of one namespace."""
    paths, _ = ensure_built()
    libs = {src: ctypes.CDLL(str(path)) for src, path in paths.items()}
    fns = {}
    for name, (src, argtypes) in ENTRY_POINTS.items():
        fn = getattr(libs[src], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return types.SimpleNamespace(libraries=libs, **fns)
