"""Build a CUDA kernel's sources into a shared library with a plain C
interface (``nvcc`` by hand, loaded with :mod:`ctypes` by the kernel's
launcher), shared by the port's CUDA kernels.

A library goes to ``build/cuda/<name>-<hash>.so`` at the root of the
checkout, named by a hash of its own sources and flags: a changed source
builds anew, an unchanged one is built once per checkout.  The compiler's
report (with ``-Xptxas -v``: registers, shared memory, spills) is kept
beside it as ``<name>-<hash>.log``.  Nothing here runs at import: a kernel
builds at its first launch, so the modules import on hosts without ``nvcc``
or a card.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

__all__ = ["NVCC_FLAGS", "build_library", "default_build_dir", "nvcc"]

# sm_90a (Hopper); IEEE float math (no --use_fast_math); the ptxas report
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def build_library(name: str, sources: Sequence[Path], build_dir: Path,
                  flags: Sequence[str] = NVCC_FLAGS) -> Path:
    """Compile ``sources`` into ``build_dir/<name>-<hash>.so`` unless a
    library built from the same sources and flags is there; returns its
    path.  Raises with the compiler's output when nvcc fails."""
    h = hashlib.sha256()
    for src in sources:
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
