"""Build the port's CUDA sources into shared libraries and load them.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into ``build/repro_torch/<stem>-<hash>.so`` at the root of the
checkout, the hash covering the source, the headers beside it, the shared
headers of ``kernels/csrc`` and the flags, so an edited source or header
never loads a stale library.
:func:`build_all` starts one ``nvcc`` per source at once.  Flags: ``-fmad=false`` (no contraction of
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
from typing import Dict, List, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# headers every source may include (csrc/hopper.cuh: wgmma, mbarrier, TMA)
SHARED_HEADERS = Path(__file__).resolve().parent / "csrc"
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
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")) + \
            sorted(SHARED_HEADERS.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:12]}.so"


def build_all(sources: Sequence[Path]) -> List[Tuple[Path, Optional[str]]]:
    """Compile every source whose library does not exist yet, one ``nvcc``
    per source, all started together.  Returns ``(library, nvcc output)``
    per source (output ``None`` when nothing was compiled); raises with
    nvcc's output if a compile fails."""
    out: List[Tuple[Path, Optional[str]]] = []
    running = []
    for source in map(Path, sources):
        lib = library_path(source)
        out.append((lib, None))
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((len(out) - 1, source, tmp, proc))
    failed = []
    for j, source, tmp, proc in running:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"CUDA build of {source.name} failed (nvcc exit "
                          f"{proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out[j][0])
        out[j] = (out[j][0], text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    source = Path(source)
    lib = _LIBS.get(source)
    if lib is None:
        lib = _LIBS[source] = ctypes.CDLL(str(build_all([source])[0][0]))
    return lib
