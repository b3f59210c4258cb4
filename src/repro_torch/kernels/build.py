"""Build and load the hand-written Hopper kernels.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` on its own into a shared library for ``sm_90a``, then loaded with
``ctypes``; device code that two sources share lives in a ``csrc/*.cuh``
header.  The build happens at first use into ``build/repro_torch_kernels/``
at the root of the checkout (listed in ``.gitignore``); a library's file name
carries the hash of its source, the headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  All missing libraries are compiled in
parallel, one ``nvcc`` process per source.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gating", "dequant", "dequant_matmul", "flash_decode", "flash_decode_contig",
           "grouped_matmul")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# argument types of every C entry point (pointers and the stream as void*,
# float scalars as c_float, an int result through an int*)
SIGNATURES = {
    "gating": {
        "gating_topk_launch": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "stacked_gating_launch": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P),
        "gating_regs": (_I, _I, _I, _I, _IP),
        "gating_layout": (_IP,),
    },
    "dequant": {
        "grouped_dequant_matmul_launch": (_P, _I, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _I, _P),
        "grouped_dequant_combine_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P,
                                           _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "grouped_mmv_tensor_map": (_P, _I, _I, _I, _I, _P),
        "grouped_mmv_launch": (_P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "grouped_mmv_info": (_I, _I, _I, _I, _IP, _IP, _IP, _IP),
        "grouped_mmv_layout": (_IP,),
    },
    "dequant_matmul": {
        "dequant_matmul_launch": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        "dequant_matmul_occupancy": (_I, _I, _I, _I, _IP, _IP),
        "dequant_mmv_clusters": (_I, _I, _IP),
    },
    "flash_decode": {
        "paged_flash_decode_launch": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
        "paged_flash_decode_blocks_per_sm": (_I, _I, _I, _I, _IP),
        "flash_decode_stages": (_I, _I, _IP),
        "paged_flash_decode_regs": (_I, _I, _I, _IP, _IP),
    },
    "flash_decode_contig": {
        "flash_decode_launch": (_P, _I, _P, _P, _I, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_decode_blocks_per_sm": (_I, _I, _I, _IP),
        "flash_decode_regs": (_I, _I, _I, _IP, _IP),
    },
    "grouped_matmul": {
        "grouped_matmul_tensor_map": (_P, _I, _I, _I, _P),
        "grouped_matmul_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "grouped_matmul_info": (_I, _I, _I, _IP, _IP, _IP, _IP, _IP),
        "grouped_matmul_layout": (_IP,),
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
last_build_s = 0.0          # seconds the last build() spent in nvcc
source_build_s: Dict[str, float] = {}   # per source: seconds until its nvcc ended


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every missing library of `names` in parallel; returns the
    wall seconds spent (0.0 when all were built already)."""
    global last_build_s
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs: Dict[str, str] = {}

    def wait(n, proc):
        logs[n], _ = proc.communicate()
        source_build_s[n] = time.perf_counter() - t0

    waiters = [threading.Thread(target=wait, args=(n, proc)) for n, _, _, proc in procs]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    errors = []
    for n, out, tmp, proc in procs:
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):\n{logs[n]}")
            continue
        os.replace(tmp, out)
    last_build_s = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    return last_build_s


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use, with every
    entry point's argument and return types declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(SOURCES)
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
