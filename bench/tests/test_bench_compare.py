"""The numbers that decide ``correct``, on readings written out by hand."""

import math

from bench import compare


def _readings(m1, dx, losses=(2.0, 1.5, 1.25)):
    return {"losses": list(losses), "m1": m1, "dx": dx,
            "grad_raw": {k: [1.0] * len(v) for k, v in m1.items()}}


def test_worst_leaf():
    ref = {f"w{j}": [1.0, 2.0] for j in range(5)}
    one_off = dict(ref, w0=[1.5, 2.0])  # one leaf of node 0 half as large again
    assert compare.worst_leaf(one_off, ref) == 0.5
    assert math.isclose(compare.worst_leaf(dict(ref, w3=[1.0, 1.9]), ref), 0.05)
    assert compare.worst_leaf(dict(ref, w3=[1.0, float("nan")]), ref) == math.inf
    tiny = dict(ref, w4=[1e-9, 2.0])  # a leaf all but zero is scaled by the median leaf
    assert compare.worst_leaf(dict(tiny, w4=[1e-6, 2.0]), tiny) < 1e-5


def test_numbers_and_checks():
    ref = _readings({"a": [1.0], "b": [2.0], "c": [3.0]}, {"a": [1.0], "b": [1.0], "c": [1.0]})
    prog = _readings({"a": [1.0], "b": [2.0], "c": [3.3]}, {"a": [1.0], "b": [1.0], "c": [1.0]},
                     losses=(2.0, 1.5, 1.2500025))
    n = compare.numbers(prog, ref)
    assert math.isclose(n["grad"], 0.1) and n["change"] == 0.0
    assert math.isclose(n["loss"], 2e-6)
    assert "ef" not in n
    checks = compare.checks(n, {"loss": 1e-5, "grad": 0.2})
    assert set(checks) == {"loss", "grad"} and compare.passes(checks)
    assert not compare.passes(compare.checks(n, {"grad": 0.05}))
    missing = compare.checks(n, {"ef": 1.0})  # a number the readings lack fails
    assert missing["ef"]["value"] == math.inf and not compare.passes(missing)
    nan = compare.checks({"loss": math.nan}, {"loss": 1.0})
    assert not compare.passes(nan)


def test_median_block():
    ref = {"w": [[1.0, 1.0, 1.0, 1.0]], "v": [[2.0]]}
    one_block = {"w": [[1.5, 1.0, 1.0, 1.0]], "v": [[2.0]]}  # one matrix of the stack off
    every_block = {"w": [[1.001] * 4], "v": [[2.002]]}
    assert compare.median_block(one_block, ref) == 0.0
    assert math.isclose(compare.median_block(every_block, ref), 1e-3)
    assert compare.median_block({"w": [[1.0, 1.0]], "v": [[2.0]]}, ref) == math.inf
    ref_r = _readings({"w": [1.0], "v": [2.0]}, {"w": [1.0], "v": [2.0]})
    ref_r.update(m1_blocks=ref, dx_blocks=ref)
    prog_r = dict(ref_r, m1_blocks=every_block, dx_blocks=one_block)
    n = compare.numbers(prog_r, ref_r)
    assert math.isclose(n["grad_block"], 1e-3) and n["change_block"] == 0.0
