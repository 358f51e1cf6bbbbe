"""Build the port's CUDA source into a shared library and load it.

The ``.cu`` file has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into ``build/repro_torch/<stem>-<hash>.so`` at the root of the
checkout, the hash covering the source and the flags, so an edited source
never loads a stale library.  Flags: ``-fmad=false`` (no contraction of
multiply-add pairs — the kernel spells its one deliberate fused
multiply-add explicitly), no fast math, and ``-Xptxas -v`` for ptxas's
register / shared-memory / spill report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def library_path(source: Path) -> Path:
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(source: Path) -> Tuple[Path, Optional[str]]:
    """Compile ``source`` unless its library exists.  Returns the library
    path and nvcc's output (``None`` when nothing was compiled); raises
    with nvcc's output if the compile fails."""
    lib = library_path(source)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {Path(source).name} failed (nvcc "
                           f"exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib, proc.stdout


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    source = Path(source)
    lib = _LIBS.get(source)
    if lib is None:
        lib = _LIBS[source] = ctypes.CDLL(str(build(source)[0]))
    return lib
