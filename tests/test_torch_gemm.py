"""The model layer's f32 products (``repro_torch.kernels.gemm``): the routing
rule that sends ``x @ w`` to the 3xTF32 ``wgmma`` kernel or keeps it on
``torch.matmul``, the kernel's split emulated in torch (the plain version)
against a float64 product, and the autograd function against ``x @ w``.

The cases marked ``card`` run the kernel itself and skip on a host without a
CUDA card (``python -m pytest tests/test_torch_gemm.py -m card`` on the card).
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.gemm import ops
from repro_torch.launch import costmodel


class _OnCard(torch.Tensor):
    """A meta tensor the rule reads as a CUDA one: shapes, strides and base
    offsets of the real sizes, no memory."""

    @property
    def is_cuda(self):
        return True


def _card(shape, dtype=torch.float32, offset=0):
    n = 1
    for s in shape:
        n *= s
    t = torch.empty(n + offset, dtype=dtype, device="meta")[offset:].view(shape)
    return t.as_subclass(_OnCard)


def _case(name):
    """(x, w) of the named case."""
    olmo_x = _card((4, 1024, 2048))
    cases = {
        # olmo-1b: b4k's and b1k's MLP, attention and tied head
        "olmo w_in b4k": (olmo_x, _card((2048, 8192))),
        "olmo w_out b4k": (_card((4, 1024, 8192)), _card((8192, 2048))),
        "olmo wq b4k": (olmo_x, _card((2048, 2048))),
        "olmo w_in b1k": (_card((1, 1024, 2048)), _card((2048, 8192))),
        "olmo tied head table.T": (olmo_x, _card((50304, 2048)).t()),
        # granite-moe-1b-a400m: attention (16 / 8 heads of 64), the untied head
        "granite wq": (_card((4, 1024, 1024)), _card((1024, 1024))),
        "granite wk": (_card((4, 1024, 1024)), _card((1024, 512))),
        "granite head 49155 wide": (_card((4, 1024, 1024)), _card((1024, 49155))),
        # decode: M = batch
        "decode M 8": (_card((8, 1, 2048)), _card((2048, 8192))),
        "M at the threshold": (_card((ops.MIN_ROWS, 2048)), _card((2048, 2048))),
        "M under the threshold": (_card((ops.MIN_ROWS - 1, 2048)), _card((2048, 2048))),
        "bf16": (_card((4, 1024, 2048), torch.bfloat16), _card((2048, 8192), torch.bfloat16)),
        "f32 x, bf16 w": (olmo_x, _card((2048, 8192), torch.bfloat16)),
        "x misaligned base": (_card((4, 1024, 2048), offset=1), _card((2048, 8192))),
        "w misaligned base": (olmo_x, _card((2048, 8192), offset=2)),
        "w row stride 2050": (olmo_x, _card((2048, 2050))[:, :2048]),
        "w column block of a wider matrix": (olmo_x, _card((2048, 4096))[:, 1024:3072]),
        "x M-major (a transposed view)": (_card((2048, 4096)).t(), _card((2048, 2048))),
        "x leading dims not foldable": (_card((1024, 4, 2048)).transpose(0, 1),
                                        _card((2048, 2048))),
        # any N and K from 1 (TMA fills out-of-range reads with zeros, the
        # epilogue checks its bounds), N a multiple of 4 for the output's rows
        "N of 8": (olmo_x, _card((2048, 8))),
        "N of 6": (olmo_x, _card((2048, 6))),
        "K of 4": (_card((4, 1024, 4)), _card((4, 2048))),
        "K of 0": (_card((4, 1024, 0)), _card((0, 2048))),
        "3-D weight": (olmo_x, _card((1, 2048, 2048))),
        "meta (the dry run)": (torch.empty((4, 1024, 2048), device="meta"),
                               torch.empty((2048, 8192), device="meta")),
        "CPU": (torch.zeros((2, 512, 64)), torch.zeros((64, 64))),
    }
    return cases[name]


ROUTES = {
    "olmo w_in b4k": True,
    "olmo w_out b4k": True,
    "olmo wq b4k": True,
    "olmo w_in b1k": True,
    "olmo tied head table.T": True,
    "granite wq": True,
    "granite wk": True,
    "granite head 49155 wide": False,
    "decode M 8": False,
    "M at the threshold": True,
    "M under the threshold": False,
    "bf16": False,
    "f32 x, bf16 w": False,
    "x misaligned base": False,
    "w misaligned base": False,
    "w row stride 2050": False,
    "w column block of a wider matrix": True,
    "x M-major (a transposed view)": True,
    "x leading dims not foldable": False,
    "N of 8": True,
    "N of 6": False,
    "K of 4": True,
    "K of 0": False,
    "3-D weight": False,
    "meta (the dry run)": False,
    "CPU": False,
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routing_rule(name):
    x, w = _case(name)
    assert ops.routes(x, w) is ROUTES[name]


def test_tf32_round_is_the_kernels_rule():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, -(1 + ulp / 2),
                      1 + 3 * ulp / 4])
    want = torch.tensor([1.0, 1 + ulp, 1.0, -(1 + ulp), 1 + ulp])
    assert torch.equal(gk.tf32_round(x), want)  # to nearest, ties away from zero
    r = gk.tf32_round(torch.randn(1000, generator=torch.Generator().manual_seed(0)))
    assert not torch.any(r.view(torch.int32) & 0x1FFF)


def _rel(c, ref):
    return float((c.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("k", [2048, 4096, 8192])
def test_split_with_kblock_promotion_against_float64(k):
    g = torch.Generator().manual_seed(k)
    a = torch.randn(64, k, generator=g)
    b = torch.randn(k, 64, generator=g)
    ref = a.double() @ b.double()
    err = _rel(gk.gemm_plain(a, b), ref)
    err_f32 = _rel(a @ b, ref)
    err_tf32 = _rel(gk.tf32_round(a) @ gk.tf32_round(b), ref)
    assert err <= 2 * err_f32, (err, err_f32)
    assert err * 10 <= err_tf32, (err, err_tf32)


def _check_linear(x, w):
    x1 = x.detach().clone().requires_grad_()
    w1 = w.detach().clone().requires_grad_()
    y1 = ops._Linear.apply(x1, w1)
    x2 = x.detach().clone().requires_grad_()
    w2 = w.detach().clone().requires_grad_()
    y2 = x2 @ w2
    gy = torch.randn(y2.shape, generator=torch.Generator().manual_seed(1)).to(y2.device)
    y1.backward(gy)
    y2.backward(gy)
    for got, want in ((y1, y2), (x1.grad, x2.grad), (w1.grad, w2.grad)):
        assert got.shape == want.shape
        got, want = got.detach(), want.detach()
        assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    return x1, w1, x2, w2


def test_linear_function_equals_matmul_3d_x():
    g = torch.Generator().manual_seed(0)
    _check_linear(torch.randn(2, 48, 96, generator=g), torch.randn(96, 40, generator=g))


def test_linear_function_equals_matmul_transposed_weight_view():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 48, 64, generator=g)
    table = torch.randn(100, 64, generator=g)  # (V, d): the tied head's w is table.T
    t1 = table.clone().requires_grad_()
    t2 = table.clone().requires_grad_()
    y1 = ops._Linear.apply(x, t1.T)
    y2 = x @ t2.T
    gy = torch.randn(y2.shape, generator=g)
    y1.backward(gy)
    y2.backward(gy)
    y1, y2 = y1.detach(), y2.detach()
    assert float((y1 - y2).abs().max()) <= 2e-6 * float(y2.abs().max())
    assert float((t1.grad - t2.grad).abs().max()) <= 2e-6 * float(t2.grad.abs().max())
    # the gradient in the table's own layout, as torch's mm gives it
    assert t1.grad.stride() == t2.grad.stride()


def test_linear_keeps_cpu_products_on_matmul():
    ops.reset_counts()
    x, w = torch.randn(2, 600, 32), torch.randn(32, 16)
    assert torch.equal(ops.linear(x, w), torch.matmul(x, w))
    assert ops.linear.matmuls == 1 and gk.gemm_launch.launches == 0


def test_a_product_is_one_gemm_unit_under_the_cost_model():
    a, b = torch.randn(40, 24), torch.randn(24, 16)
    c = costmodel.analyze(lambda: ops.product(a, b), ())
    assert c.kernel_launches == {"gemm": 1}
    assert c.product_flops == c.kernel_flops["gemm"] == 2 * 40 * 24 * 16


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel is built by nvcc for sm_90a)")
    return torch.device("cuda")


def _operands(m, n, k, a_major, b_major, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=g) if a_major == "k" else torch.randn(k, m, generator=g).t()
    b = torch.randn(k, n, generator=g) if b_major == "n" else torch.randn(n, k, generator=g).t()
    return a.to(device), b.to(device)


@pytest.mark.card
@pytest.mark.parametrize("a_major", ["k", "m"])
@pytest.mark.parametrize("b_major", ["n", "k"])
@pytest.mark.parametrize("shape", [(256, 384, 512), (300, 132, 100), (640, 256, 4096),
                                   (1028, 4, 4), (260, 8, 20)])
def test_kernel_against_float64_every_layout(card, shape, a_major, b_major):
    a, b = _operands(*shape, a_major, b_major, card)
    ref = a.double() @ b.double()
    got = gk.gemm_launch(a, b)
    assert got.is_contiguous()
    assert _rel(got, ref) <= 2 * max(_rel(a @ b, ref), _rel(gk.gemm_plain(a, b), ref))
    assert torch.equal(got, gk.gemm_launch(a, b))


@pytest.mark.card
def test_linear_on_the_card_routes_and_matches(card):
    ops.reset_counts()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 512, 256, generator=g).to(card)
    table = torch.randn(1024, 256, generator=g).to(card)
    for w in (torch.randn(256, 512, generator=g).to(card), table.T):
        assert ops.routes(x, w)
        _check_linear(x, w)
    # two forwards and four backward products
    assert gk.gemm_launch.launches == 6 and ops.linear.matmuls == 0
