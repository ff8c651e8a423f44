"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file under ``repro_torch/kernels`` is compiled on its
own into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<stem>-<hash>.so <src>

at first use, into ``build/kernels/`` at the repository root (listed in
``.gitignore``), with ``-I`` for each of ``INCLUDE_DIRS`` (the Hopper
helpers ``flash_attention/csrc/hopper_sm90.cuh``, which K4's backward
includes too).  The file name carries a hash of the source, of every
header it includes (its ``#include "..."`` lines followed, found beside the
source first and then in ``INCLUDE_DIRS``, as nvcc finds them) and of the
flags, so an edited source or shared header is rebuilt and a stale library
is never loaded.
``build()`` starts one ``nvcc`` per missing library, all at once, and
raises with the compiler's output if any of them fails; the ``ptxas``
report (registers, shared memory, spills) is kept beside each library as
``<stem>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# searched after a source's own directory for its quoted includes
INCLUDE_DIRS: Tuple[Path, ...] = (KERNELS_DIR / "flash_attention" / "csrc",)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)

# library name -> CUDA source (one library per source file)
SOURCES: Dict[str, Path] = {
    "flash_attention_fwd":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_fwd.cu",
    "flash_attention_bwd":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention_bwd.cu",
    "flash_decode_fwd":
        KERNELS_DIR / "flash_attention" / "csrc" / "flash_decode_fwd.cu",
    "quant_offload":
        KERNELS_DIR / "quant_offload" / "csrc" / "quant_offload.cu",
    "ssd_scan_fwd":
        KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan_fwd.cu",
    "ssd_scan_bwd":
        KERNELS_DIR / "ssd_scan" / "csrc" / "ssd_scan_bwd.cu",
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (neither on PATH nor in "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def included_headers(src: Path) -> List[Path]:
    """Every header ``src`` includes with ``#include "..."``, directly or
    through another header, each found as nvcc finds it: beside the file
    that includes it, then in ``INCLUDE_DIRS``.  An include found nowhere
    is left to nvcc to report."""
    found: List[Path] = []
    todo = [src]
    while todo:
        cur = todo.pop()
        for name in _INCLUDE.findall(cur.read_text()):
            for d in (cur.parent, *INCLUDE_DIRS):
                hdr = (d / name).resolve()
                if hdr.is_file():
                    if hdr not in found:
                        found.append(hdr)
                        todo.append(hdr)
                    break
    return found


def source_hash(src: Path) -> str:
    """Hash of a CUDA source, the headers it includes and the nvcc
    flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(included_headers(src), key=lambda p: (p.name, str(p))):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{source_hash(SOURCES[name])}.so"


def compile_all(jobs: Dict[str, Tuple[Path, Path]]) -> None:
    """Compile name -> (source, library) with one ``nvcc`` per job, all
    started together, so the build takes as long as its slowest source.
    Each library is written under a temporary name and renamed into place:
    pytest workers on one card may build the same library at once, and none
    of them may load half a file."""
    nvcc = nvcc_path()
    procs = {}
    for n, (src, lib) in jobs.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-I{d}" for d in INCLUDE_DIRS), "-o",
               str(tmp), str(src)]
        procs[n] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (lib, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named library that is missing; return name -> library
    path for all of them."""
    names = list(SOURCES if names is None else names)
    paths = {n: library_path(n) for n in names}
    todo = {n: (SOURCES[n], paths[n]) for n in names if not paths[n].exists()}
    if todo:
        compile_all(todo)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``; every
    library exports ``cuda_error_string`` for the message."""
    if err != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({fn(err).decode(errors='replace')})")
