"""The port's nvcc build helper (``repro_torch.kernels.cuda_build``) on the
CPU, with a stand-in ``nvcc``: a script in ``tmp_path`` that writes its
``-o`` file and logs its arguments.  A library is named by a hash of its
sources, of the headers they include and of the flags, so an edit to an
included header builds anew, and an unchanged tree reuses the library."""

import os
import stat
import sys

import pytest

from repro_torch.kernels import cuda_build

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write("built")
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A fake nvcc on PATH; a kernel source including a shared header
    (which includes another) from a shared include dir."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    log = tmp_path / "nvcc.log"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ.get("PATH", ""))
    shared = tmp_path / "csrc"
    shared.mkdir()
    (shared / "mma.cuh").write_text('#pragma once\n#include "detail.cuh"\n')
    (shared / "detail.cuh").write_text("#pragma once\n// v1\n")
    ksrc = tmp_path / "kern" / "csrc"
    ksrc.mkdir(parents=True)
    (ksrc / "local.cuh").write_text("#pragma once\n")
    src = ksrc / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "mma.cuh"\n#include "local.cuh"\n'
                   '#include "missing.cuh"\n')
    return {"src": src, "shared": shared, "log": log, "out": tmp_path / "out"}


def _build(t):
    return cuda_build.build_library("k", (t["src"],), t["out"], include_dirs=(t["shared"],))


def test_included_headers_follow_quoted_includes(tree):
    got = cuda_build.included_headers((tree["src"],), (tree["shared"],))
    assert got == [(tree["shared"] / "mma.cuh").resolve(),
                   (tree["src"].parent / "local.cuh").resolve(),
                   (tree["shared"] / "detail.cuh").resolve()]


def test_header_edit_rebuilds_and_unchanged_tree_reuses(tree):
    first = _build(tree)
    assert first.read_text() == "built" and first.parent == tree["out"]
    calls = tree["log"].read_text().splitlines()
    assert len(calls) == 1 and f"-I{tree['shared']}" in calls[0].split()
    assert _build(tree) == first  # unchanged: reused, nvcc not run again
    assert len(tree["log"].read_text().splitlines()) == 1
    # an edit two includes deep names a new library and runs nvcc again
    (tree["shared"] / "detail.cuh").write_text("#pragma once\n// v2\n")
    second = _build(tree)
    assert second != first and second.exists()
    assert len(tree["log"].read_text().splitlines()) == 2
    assert _build(tree) == second
    assert len(tree["log"].read_text().splitlines()) == 2


def test_port_kernels_hash_the_shared_header():
    """Both CUDA kernels include the shared tensor-core header, so an edit
    to it changes their libraries' names."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.mlstm_chunk import kernel as ml

    shared = (cuda_build.INCLUDE_DIRS[0] / "mma_tf32x3.cuh").resolve()
    for mod in (fa, ml):
        assert shared in cuda_build.included_headers(mod.SOURCES)
