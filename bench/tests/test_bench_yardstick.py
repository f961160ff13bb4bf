"""The frozen FLOP and byte counts against sums written out by hand."""

import json
from pathlib import Path

from bench import yardstick

BENCH = Path(__file__).resolve().parent.parent


def _load(kind, name):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def test_olmo_matmul_params_and_step_flops():
    model = _load("configs", "olmo-1b.l8")
    d, f, v, L = 2048, 8192, 50304, 8
    per_layer = 4 * d * d + 3 * d * f  # q, k, v, o (MHA, hd 128) and SwiGLU
    assert yardstick.matmul_params(model) == L * per_layer + d * v == 639_893_504
    tokens = 4 * 4 * 1024
    attn = 12 * L * 16 * 128 * 1024  # per token: QK^T and PV, forward and backward
    want = tokens * (6 * 639_893_504 + attn)
    assert yardstick.step_flops(model, _load("traffic", "b4k"), 4) == want
    assert abs(want / 1e12 - 66.2) < 0.05
    assert yardstick.step_flops(model, _load("traffic", "b1k"), 4) == want / 4


def test_granite_active_params():
    model = _load("configs", "granite-moe-1b-a400m.l12")
    d, f, v, L, E, k = 1024, 512, 49155, 12, 32, 8
    attn = d * 16 * 64 * 2 + d * 8 * 64 * 2  # q, o at 16 heads; k, v at 8
    per_layer = attn + d * E + k * 3 * d * f
    assert yardstick.matmul_params(model) == L * per_layer + d * v
    assert abs(yardstick.matmul_params(model) / 1e6 - 239.4) < 0.1


def test_tail_bytes():
    # decentlam on planes: grad_step reads x, g and writes the payload;
    # decentlam_post reads x, mix, m and writes x, m: 8 f32 planes a step
    elems = 4 * 648_000 * 1024
    assert yardstick.tail_bytes(elems, {"grad_step": 1, "decentlam_post": 1}) == 8 * 4 * elems
    assert yardstick.tail_bytes(elems, {"grad_step": 2}) == 2 * 3 * 4 * elems
    assert abs(yardstick.F32_ACCURATE_FLOP_PER_S / 1e12 - 164.9) < 1e-9
