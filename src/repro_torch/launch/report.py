"""Tables over the dry run's records (the port of ``repro.launch.report``).

``PYTHONPATH=src python -m repro_torch.launch.report [--tag baseline] [--mesh pod1]``
prints a markdown roofline table of ``experiments/dryrun_torch/<tag>/<mesh>``
(:mod:`.dryrun`); ``--compare tagA tagB`` prints the before/after diff for
cells present in both tags.  The terms are on the H100's constants
(:mod:`.roofline`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import OUT

__all__ = ["ARCH_ORDER", "SHAPE_ORDER", "compare", "fmt_s", "load", "main", "table"]


def load(tag: str, mesh: str, root: str = OUT) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(root, tag, mesh, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def fmt_s(x: float) -> str:
    if x >= 1e-1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


ARCH_ORDER = [
    "xlstm-350m", "hymba-1.5b", "h2o-danube-1.8b", "qwen3-8b", "olmo-1b",
    "qwen3-0.6b", "granite-moe-3b-a800m", "granite-moe-1b-a400m",
    "internvl2-2b", "whisper-tiny",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _key(r):
    order = lambda seq, x: seq.index(x) if x in seq else len(seq)  # noqa: E731
    return (order(ARCH_ORDER, r["arch"]), order(SHAPE_ORDER, r["shape"]), r["shape"])


def table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MF-util | HBM (args+temp) | colls | kernel launches |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | *skipped* "
                f"| — | — | {r['reason'].split(':')[0]} | — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR {r['error'][:60]} |")
            continue
        t = r["roofline"]
        mem = r["memory"]
        hbm = (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30
        ncoll = sum(r["collectives"]["counts"].values())
        launches = ", ".join(f"{k} {v}" for k, v in r["raw"]["kernel_launches"].items()) or "—"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} "
            f"| {fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} "
            f"| **{t['dominant']}** | {r['model_flops_utilization']*100:.0f}% "
            f"| {hbm:.1f} GiB | {ncoll} | {launches} |"
        )
    return "\n".join(lines)


def compare(tag_a: str, tag_b: str, mesh: str, root: str = OUT) -> str:
    a = {(r["arch"], r["shape"]): r for r in load(tag_a, mesh, root) if r["status"] == "ok"}
    b = {(r["arch"], r["shape"]): r for r in load(tag_b, mesh, root) if r["status"] == "ok"}
    lines = [
        f"| cell | term | {tag_a} | {tag_b} | delta |",
        "|---|---|---|---|---|",
    ]
    for key in sorted(set(a) & set(b)):
        ra, rb = a[key], b[key]
        for term in ("compute_s", "memory_s", "collective_s"):
            va, vb = ra["roofline"][term], rb["roofline"][term]
            if va == 0:
                continue
            delta = (vb - va) / va * 100
            mark = " <" if term == ra["roofline"]["dominant"] + "_s" else ""
            lines.append(
                f"| {key[0]}/{key[1]} | {term[:-2]}{mark} | {fmt_s(va)} "
                f"| {fmt_s(vb)} | {delta:+.1f}% |"
            )
    return "\n".join(lines)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tag", default="baseline")
    p.add_argument("--mesh", default="pod1")
    p.add_argument("--root", default=OUT)
    p.add_argument("--compare", nargs=2, default=None)
    args = p.parse_args(argv)
    if args.compare:
        print(compare(args.compare[0], args.compare[1], args.mesh, args.root))
    else:
        print(table(load(args.tag, args.mesh, args.root)))


if __name__ == "__main__":
    main()
