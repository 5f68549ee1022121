"""Build the port's CUDA sources into shared libraries and load them.

Each source (a ``kernel.cu``, and the flash and SSD backwards'
``backward.cu``) has a plain C interface and is compiled by ``nvcc`` into
its own shared library, loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  Sources include the port's shared headers
(``wgmma.cuh``, ``tma.cuh``, ``mma_sync.cuh``) from ``INCLUDE_DIRS``.
Libraries go under ``build/repro_torch/`` at the root of the checkout,
named by a hash of the source, of every header in ``INCLUDE_DIRS`` and of
the flags, so a changed source or header rebuilds and an unchanged one is
reused.
:func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the first CUDA launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
#: every CUDA source of the port
SOURCES = tuple(KERNELS_DIR / name for name in (
    "proxy_blocks/kernel.cu", "flash_attention/kernel.cu",
    "flash_attention/backward.cu", "ssd/kernel.cu", "ssd/backward.cu"))
#: where ``#include "..."`` finds the port's shared headers
INCLUDE_DIRS = (KERNELS_DIR,)
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}
#: ptxas register/shared-memory report of each build, by source
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return nvcc


def library_path(source: Path) -> Path:
    h = hashlib.sha256(Path(source).read_bytes())
    headers = sorted(p for d in INCLUDE_DIRS for p in Path(d).glob("*.cuh"))
    for header in headers:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    source = Path(source)
    name = source.parent.name + ("" if source.stem == "kernel"
                                 else f"_{source.stem}")
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(source: Path, lib: Path) -> subprocess.Popen:
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    includes = [f"-I{d}" for d in INCLUDE_DIRS]
    cmd = [nvcc_path(), *NVCC_FLAGS, *includes, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return proc


def build_all(sources=SOURCES) -> dict[Path, Path]:
    """Compile every source not yet built, all ``nvcc`` runs in parallel.
    Returns ``{source: library}``; raises with nvcc's output on failure."""
    libs = {Path(s): library_path(s) for s in sources}
    procs = {s: _start(s, lib) for s, lib in libs.items() if not lib.exists()}
    errors = []
    for s, proc in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[str(s)] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {s}:\n{log}")
            continue
        os.replace(proc.tmp, libs[s])   # atomic: readers never see a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load(source: Path, prototypes: dict | None = None) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first call.

    ``prototypes`` maps a function of the library to its ``(argtypes,
    restype)``; they are set once, when the library is loaded.  A library
    already loaded costs one dict lookup, which every kernel launch pays."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    source = Path(source)
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_all([source])[source]
            lib = ctypes.CDLL(str(path))
            lib.cuda_error_name.restype = ctypes.c_char_p
            lib.cuda_error_name.argtypes = [ctypes.c_int]
            for name, (argtypes, restype) in (prototypes or {}).items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIBS[source] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.cuda_error_name(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
