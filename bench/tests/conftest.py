"""The benchmark's own tests: ``python -m pytest bench/tests`` from the root
of the repository.  Tests that need a CUDA card take the ``cuda`` fixture,
which skips without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.utils import resolve_device

    return resolve_device("cuda")
