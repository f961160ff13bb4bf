"""Build a CUDA kernel's sources into a shared library with a plain C
interface (``nvcc`` by hand, loaded with :mod:`ctypes` by the kernel's
launcher), shared by the port's CUDA kernels.

A library goes to ``build/cuda/<name>-<hash>.so`` at the root of the
checkout, named by a hash of its sources, of every header they include
with ``#include "..."`` (found beside the including file or on the include
path, recursively) and of the flags: a changed source or header builds
anew, an unchanged one is built once per checkout.  The include path holds
``kernels/csrc/``, the headers the kernels share.  The compiler's
report (with ``-Xptxas -v``: registers, shared memory, spills) is kept
beside it as ``<name>-<hash>.log``.  Nothing here runs at import: a kernel
builds at its first launch, so the modules import on hosts without ``nvcc``
or a card.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

__all__ = ["INCLUDE_DIRS", "NVCC_FLAGS", "build_library", "default_build_dir", "included_headers",
           "nvcc"]

# sm_90a (Hopper); IEEE float math (no --use_fast_math); the ptxas report
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# the headers the port's kernels share (mma_tf32x3.cuh)
INCLUDE_DIRS = (Path(__file__).resolve().parent / "csrc",)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def default_build_dir() -> Path:
    # src/repro_torch/kernels -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "cuda"


def nvcc() -> str:
    """The ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc`` (``/usr/local/cuda``
    by default); raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
                       "port's CUDA kernels are built from their sources at first use")


def included_headers(sources: Sequence[Path],
                     include_dirs: Sequence[Path] = INCLUDE_DIRS) -> list[Path]:
    """The headers that ``sources`` include with ``#include "..."``, found
    beside the including file or in ``include_dirs`` (as nvcc looks them up),
    and the headers those include, each once, in the order first met.  A
    quoted include found nowhere is left to nvcc to report."""
    seen: list[Path] = []
    todo = [Path(s) for s in sources]
    while todo:
        cur = todo.pop(0)
        for inc in _INCLUDE.findall(cur.read_text()):
            for d in (cur.parent, *map(Path, include_dirs)):
                cand = (d / inc).resolve()
                if cand.is_file():
                    if cand not in seen:
                        seen.append(cand)
                        todo.append(cand)
                    break
    return seen


def build_library(name: str, sources: Sequence[Path], build_dir: Path,
                  flags: Sequence[str] = NVCC_FLAGS,
                  include_dirs: Sequence[Path] = INCLUDE_DIRS) -> Path:
    """Compile ``sources`` into ``build_dir/<name>-<hash>.so`` unless a
    library built from the same sources, included headers and flags is
    there; returns its path.  Raises with the compiler's output when nvcc
    fails."""
    flags = [*flags, *(f"-I{d}" for d in include_dirs)]
    h = hashlib.sha256()
    for src in (*sources, *included_headers(sources, include_dirs)):
        h.update(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    out = Path(build_dir) / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) on {name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out
