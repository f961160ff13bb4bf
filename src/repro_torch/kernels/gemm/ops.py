"""The model layer's f32 products: ``linear(x, w)`` is ``x @ w``, with the
forward product and both backward products on the 3xTF32 ``wgmma`` kernel
(:func:`.kernel.gemm_launch`) wherever the routing rule sends them.

**The routing rule** (:func:`routes`) reads only the inputs: ``x`` and ``w``
on one CUDA device, both float32, ``w`` 2-D, ``x``'s leading dimensions
foldable into M >= :data:`MIN_ROWS` rows without a copy, N and K not 0, N a
multiple of 4 (the output's rows, and so dY's, 16-byte aligned), and every
operand as the kernel's TMA loads take it (one
unit stride, the other a multiple of 16 bytes, 16-byte aligned bases).  What
it sends to the kernel launches it or raises; everything else (decode's few
rows, bf16, CPU and meta tensors, a head whose row stride is not a multiple of
16 bytes) goes to ``torch.matmul`` and is counted in ``linear.matmuls``.

**The autograd function** saves what ``x @ w`` saves (``x`` and ``w``, as
views) and computes dX = dY . W^T and dW = X^T . dY on the kernel, each
operand read by strides.  A weight that is a transposed view (the tied
head's ``table.T``) gets its gradient as torch's ``mm`` gives it, in the
weight's own layout: (dY^T . X)^T.  On the CPU (the tests) the function's
products take the plain version (:func:`.kernel.gemm_plain`).  Under a cost
recorder each launch is one ``gemm`` unit whose FLOPs count as products.
"""

from __future__ import annotations

import torch

from ...launch.costmodel import kernel_unit
from .kernel import gemm_launch, gemm_plain, operand_ok, work

__all__ = ["MIN_ROWS", "linear", "reset_counts", "routes"]

# Rows from which the kernel beats cuBLAS's FFMA sgemm on an H100 80GB HBM3
# (700 W) at the model's widths: a 2,048 x 2,048 product of 1,024 rows takes
# 0.102 ms against 0.186, of 512 rows 0.102 against 0.104 (a tie), of 256
# rows 0.101 against 0.058.  Below, 128-row tiles leave most of the 132 SMs
# idle.
MIN_ROWS = 1024


def _rows(x: torch.Tensor) -> torch.Tensor | None:
    """``x`` (..., K) as an (M, K) view, or None where folding the leading
    dimensions would copy."""
    if x.ndim == 2:
        return x
    if x.ndim < 2:
        return None
    shape, stride = x.shape, x.stride()
    for i in range(x.ndim - 2):
        if shape[i] != 1 and stride[i] != stride[i + 1] * shape[i + 1]:
            return None
    return x.view(-1, shape[-1])


def routes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``x @ w`` goes to the kernel (the module docstring's rule)."""
    if not (x.is_cuda and x.dtype is torch.float32 and w.dtype is torch.float32
            and w.ndim == 2 and w.device == x.device):
        return False
    k, n = w.shape
    # n % 4: the output's rows, and so dY's, 16-byte aligned for the backward
    if n == 0 or k == 0 or n % 4 or x.shape[-1] != k:
        return False
    x2 = _rows(x)
    return x2 is not None and x2.shape[0] >= MIN_ROWS and operand_ok(x2) and operand_ok(w)


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the function takes it: the kernel on CUDA, the plain
    version on the CPU; one ``gemm`` unit under a cost recorder."""
    m, k = a.shape
    with kernel_unit("gemm", lambda: work(m, b.shape[1], k), product=True):
        if a.is_cuda:
            return gemm_launch(a, b)
        return gemm_plain(a, b)


def _operand(t: torch.Tensor) -> torch.Tensor:
    # autograd's dY is contiguous as a rule; a broadcast one (stride 0) is
    # laid out once so that the kernel can read it
    return t if operand_ok(t) else t.contiguous()


class _Linear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return product(_rows(x), w).view(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy2 = _operand(gy.reshape(-1, gy.shape[-1]))
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = product(gy2, w.t()).view(x.shape)
        if ctx.needs_input_grad[1]:
            x2 = _rows(x)
            if w.stride(0) == 1 and w.stride(1) != 1:
                gw = product(gy2.t(), x2).t()
            else:
                gw = product(x2.t(), gy2)
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., K) and w (K, N): on the kernel where
    :func:`routes` says so, else ``torch.matmul``."""
    if routes(x, w):
        return _Linear.apply(x, w)
    linear.matmuls += 1
    return torch.matmul(x, w)


def reset_counts() -> None:
    """Set the kernel's launch count and the count of products kept on
    ``torch.matmul`` to 0."""
    gemm_launch.launches = 0
    linear.matmuls = 0


reset_counts()
