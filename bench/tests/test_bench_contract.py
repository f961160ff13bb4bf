"""``BENCHMARK.json`` against the rules its checker applies, and every file a
cell is found by: its configuration, traffic mix, limits, the references of
its family, trainer, topology and compressor, and the metrics' readers."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_size$|_dim$|_rank$|expan|factor$|per_tok)")


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"] and SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_files():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
        assert set(c["reduced"]) == set(conf["published"])
        assert (ROOT / "bench" / "reference" / f"{conf['run']['family']}.py").exists()
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
        trainer = traffic["trainer"]
        ref = ROOT / "bench" / "reference"
        assert (ref / f"{trainer['algorithm']}.py").exists()
        assert (ref / "topology" / f"{trainer['topology']}.py").exists()
        if trainer["compression"] is not None:
            assert (ref / "compression" / f"{trainer['compression']}.py").exists()
        limits = json.loads((ROOT / "bench" / "limits" / f"{w['name']}.json").read_text())
        assert {"loss", "grad", "change"} <= set(limits)


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
    for c in cells:  # every cell reports a per-layer metric
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
