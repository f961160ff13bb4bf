"""The benchmark's run: set-up, the measured window, the traced steps, the
per-layer readers and the comparison with the plain reference.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``bench/configs/<config>.json`` (the model as run), ``bench/traffic/
<traffic>.json`` (the batches and the trainer's settings),
``bench/limits/<cell>.json`` (the limit of each number compared),
``bench/metrics/<metric>.py`` (one reader per metric, end-to-end or per
layer) and the plain references under ``bench/reference`` (the family's
loss, the trainer by its ``algorithm``, the mixing matrix by its
``topology``, the compressor by its ``compression``).  The configuration's
``run.port_fields`` maps the port's model fields to the file's keys, and
the traffic's ``trainer`` holds ``TrainConfig``'s fields by name (its
``schedule`` as ``ScheduleConfig``'s), so a new configuration, mix or
metric is new files and entries.

The system under test is ``repro_torch``'s stacked DecentLaM trainer: the
step of ``train.step.build_train_step`` on the flat planes of
``train.train_state.init_train_state``, with the parameters that
:mod:`bench.weights` makes from the seed written into the planes.  Set-up
drives that step through its first three steps on the pool's first three
batches and keeps what the comparison reads of them (each step's loss, the
momentum after the first step, the parameters' change after the third, the
error-feedback residual); the window then steps the same state on, cycling
the pool, with no synchronisation of its own, until ``seconds`` have
passed.  After the window the program's state is freed and the reference
trains from the same seed on the same batches.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path

import torch

from . import compare, reference, traffic as traffic_mod, weights, yardstick
from .kineto import Trace

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
CHECK_STEPS = 3  # steps of set-up that the comparison follows
STEP_SPAN = "bench."  # prefix of the benchmark's own profiler spans


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str) -> Cell:
    spec = _load(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    per = [m for m in spec["per_layer"] if name in m["workloads"]]
    cell = Cell(name, int(w["chips"]), _load(ROOT / conf["file"]),
                _load(BENCH / "traffic" / f"{w['traffic']}.json"),
                _load(BENCH / "limits" / f"{name}.json"), list(spec["end_to_end"]), per)
    trainer_reference(cell).check(cell.traffic["trainer"])
    return cell


def trainer_reference(cell: Cell):
    """The plain reference of the cell's trainer (``bench/reference/<algorithm>.py``)."""
    return reference.load("algorithm", cell.traffic["trainer"]["algorithm"])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lookup(model: dict, key: str):
    """``key`` of a configuration file, ``run.<key>`` inside its ``run``."""
    node = model
    for part in key.split("."):
        node = node[part]
    return node


def program_config(model: dict):
    """The program's ``ModelConfig``: the registry entry ``run.port_arch``
    with each field of ``run.port_fields`` set from the key it names."""
    from repro_torch.configs import get_config

    run = model["run"]
    return dataclasses.replace(get_config(run["port_arch"]),
                               **{f: _lookup(model, k) for f, k in run["port_fields"].items()})


# the path under test: the Triton (or, on the CPU, plain) tail on flat planes
FIXED = ("fused_update", "fused_impl", "flat_planes")


def _field_value(default, value):
    """A JSON value as a dataclass field takes it: a dict builds the field's
    own dataclass, a list becomes a tuple."""
    if isinstance(value, dict) and dataclasses.is_dataclass(default):
        extra = set(value) - {f.name for f in dataclasses.fields(default)}
        if extra:
            raise ValueError(f"{type(default).__name__} has no fields {sorted(extra)}")
        return dataclasses.replace(default, **{k: _field_value(getattr(default, k), v)
                                               for k, v in value.items()})
    return tuple(value) if isinstance(value, list) else value


def train_config(trainer: dict, impl: str):
    """The program's ``TrainConfig`` from the traffic's ``trainer``: every
    key but ``nodes`` is a field of it, set as given."""
    from repro_torch.train.step import TrainConfig

    base = TrainConfig()
    fields = {f.name for f in dataclasses.fields(base)}
    given = {k: v for k, v in trainer.items() if k != "nodes"}
    extra = set(given) - fields
    if extra or set(given) & set(FIXED):
        raise ValueError(f"the trainer takes no {sorted(extra | (set(given) & set(FIXED)))}: "
                         f"not TrainConfig fields, or fixed by the benchmark")
    kw = {k: _field_value(getattr(base, k), v) for k, v in given.items()}
    return dataclasses.replace(base, **kw, fused_update=True, fused_impl=impl, flat_planes=True)


def leaves(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{dotted path: tensor}`` of a nested dict (empty subtrees dropped)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def node_norms(views: dict[str, torch.Tensor]) -> dict[str, list[float]]:
    return {k: [float(torch.linalg.vector_norm(v[i])) for i in range(v.shape[0])]
            for k, v in views.items()}


def block_norms(t: torch.Tensor) -> list[float]:
    """Norms of one node's leaf by block: each matrix of a stack (the
    leading axes index the blocks), or the whole leaf under three axes."""
    if t.ndim < 3:
        return [float(torch.linalg.vector_norm(t))]
    return torch.linalg.vector_norm(t.flatten(0, -3), dim=(-2, -1)).tolist()


class Program:
    """The trainer under test, its state and the cell's batches on the device."""

    def __init__(self, cell: Cell, seed: int, device: torch.device, impl: str):
        t = time.perf_counter()
        from repro_torch.core.optimizers import make_optimizer
        from repro_torch.train.step import build_train_step
        from repro_torch.train.train_state import init_train_state, model_plane_layout

        self.phases = {"import repro_torch": time.perf_counter() - t}
        tr = cell.traffic["trainer"]
        self.cell, self.seed, self.device = cell, seed, device
        t = time.perf_counter()
        self.n = int(tr["nodes"])
        self.cfg = program_config(cell.model)
        self.tcfg = train_config(tr, impl)
        self.step_fn, self.channel = build_train_step(self.cfg, self.tcfg, self.n)
        self.layout = model_plane_layout(self.cfg)
        self.state = init_train_state(self.cfg, make_optimizer(self.tcfg.opt_config()), self.n,
                                      device=device, channel=self.channel,
                                      plane_layout=self.layout)
        sync(device)
        self.phases["program"] = time.perf_counter() - t
        t = time.perf_counter()
        self.specs = weights.family(cell.model).param_specs(cell.model)
        self.load_weights()
        self.phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pool = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                     for b in traffic_mod.pool(cell.traffic, self.cfg.vocab_size, self.n, seed)]
        self.phases["pool"] = time.perf_counter() - t
        self.k = 0

    def load_weights(self) -> None:
        views = leaves(self.state["params"])
        want = {p: s for p, s, _ in self.specs}
        if set(views) != set(want):
            raise RuntimeError(f"the program's parameters {sorted(views)} are not the "
                               f"reference's {sorted(want)}")
        for path, x in weights.make(self.specs, self.seed, self.device).items():
            if tuple(views[path].shape[1:]) != tuple(x.shape):
                raise RuntimeError(f"{path}: the program holds {tuple(views[path].shape)}, "
                                   f"the reference {tuple(x.shape)}")
            views[path].copy_(x.unsqueeze(0).expand_as(views[path]))
        sync(self.device)

    @property
    def tokens_per_step(self) -> int:
        t = self.cell.traffic
        return self.n * int(t["rows_per_node"]) * int(t["seq_len"])

    @property
    def plane_elems(self) -> int:
        return sum(p.numel() for p in self.state["planes"].values())

    def step(self):
        batch = self.pool[self.k % len(self.pool)]
        self.k += 1
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics

    def check_steps(self) -> dict:
        """The first :data:`CHECK_STEPS` steps, and what the comparison reads
        of them (see the trainer's reference, ``bench/reference/<algorithm>.py``)."""
        out = {"losses": [], "seconds": []}
        for k in range(CHECK_STEPS):
            t = time.perf_counter()
            metrics = self.step()
            out["losses"].append(float(metrics["loss"]))
            out["seconds"].append(time.perf_counter() - t)
            if k == 0:
                m = self.layout.view_unpack(self.state["opt"]["m"], leading=1)
                views = leaves(m)
                out["m1"] = node_norms(views)
                out["m1_blocks"] = {p: [block_norms(v[i]) for i in range(self.n)]
                                    for p, v in views.items()}
        x0 = weights.make(self.specs, self.seed, self.device)
        x = leaves(self.state["params"])
        out["dx"] = {p: [float(torch.linalg.vector_norm(x[p][i] - x0[p]))
                         for i in range(self.n)] for p in x}
        out["dx_blocks"] = {p: [block_norms(x[p][i] - x0[p]) for i in range(self.n)]
                            for p in x}
        del x0
        if self.tcfg.compression:
            ef = self.layout.view_unpack(self.state["channel"]["comp"], leading=1)
            out["ef"] = node_norms(leaves(ef))
        return out

    def gossip_round_ms(self, rounds: int = 5) -> list[float]:
        """One round of the cell's own channel on the state's parameter
        planes, alone, ``rounds`` times after one warm-up round."""
        step = int(self.state["step"])
        payload = dict(self.state["planes"])
        times = []
        for r in range(rounds + 1):
            if self.device.type == "cuda":
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                self.state["channel"], mixed = self.channel.apply(self.state["channel"],
                                                                  payload, step)
                b.record()
                torch.cuda.synchronize(self.device)
                ms = a.elapsed_time(b)
            else:
                t0 = time.perf_counter()
                self.state["channel"], mixed = self.channel.apply(self.state["channel"],
                                                                  payload, step)
                ms = (time.perf_counter() - t0) * 1e3
            del mixed
            if r:
                times.append(ms)
        return times


@dataclasses.dataclass
class Context:
    """What a metric's reader (``bench/metrics/<name>.py``) reads: the run's
    window and set-up, and in a traced run the profiled steps' trace."""

    cell: Cell
    program: Program
    trace: Trace | None
    profiled_steps: int
    window_steps: int
    window_s: float
    stage_launches: dict
    setup_s: float = 0.0
    peak_bytes: int = 0
    _gossip: list | None = None

    @property
    def step_flops(self) -> float:
        return yardstick.step_flops(self.cell.model, self.cell.traffic, self.program.n)

    def patterns(self, name: str) -> list[str]:
        text = (BENCH / "patterns" / f"{name}.txt").read_text()
        return [ln.strip().lower() for ln in text.splitlines()
                if ln.strip() and not ln.startswith("#")]

    def gossip_round_ms(self) -> list[float]:
        if self._gossip is None:
            self._gossip = self.program.gossip_round_ms()
        return self._gossip


def read_metric(name: str, ctx: Context):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def _profile(prog: Program, steps: int):
    """``steps`` steps under the profiler: (trace, seconds, launches by op)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels.fused_update import kernel as stage_kernel

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if prog.device.type == "cuda" else [])
    stage_kernel.reset_launches()
    with profile(activities=acts) as prof:
        sync(prog.device)
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function(f"{STEP_SPAN}step"):
                prog.step()
        with record_function(f"{STEP_SPAN}sync"):
            sync(prog.device)
        seconds = time.perf_counter() - t0
    launches = dict(stage_kernel.fused_stage_launch.launches_by_op)
    return Trace.from_profiler(torch, prof), seconds, launches


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, t0: float,
             device: torch.device, impl: str = "triton", marks: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's fields (with ``log``: the
    lines for standard error).  ``marks`` are the caller's set-up phases
    since ``t0``, in seconds, for the log."""
    t_start = time.perf_counter()
    prog = Program(cell, seed, device, impl)
    t_check = time.perf_counter()
    got = prog.check_steps()
    sync(device)
    setup_s = time.perf_counter() - t0
    marks = marks or {}
    phases = {"start": t_start - t0 - sum(marks.values()), **marks, **prog.phases,
              "check_steps": time.perf_counter() - t_check,
              "steps": " ".join(f"{v:.3f}" for v in got["seconds"])}

    losses, failed = [], 0
    tw = time.perf_counter()
    while True:
        metrics = prog.step()
        losses.append(metrics["loss"])
        failed += metrics["skipped_nonfinite"] > 0
        if time.perf_counter() - tw >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - tw
    steps = len(losses)

    result = {"attempted": steps, "failed": failed, "metrics": {}, "log": []}
    prof, k, launches = None, 0, {}
    if trace:
        k = int(cell.traffic["profiled_steps"])
        prof, prof_s, launches = _profile(prog, k)
        result["attempted"] += k
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finite = all(math.isfinite(float(v)) for v in losses)
    tokens = prog.tokens_per_step
    ctx = Context(cell, prog, prof, k, steps, window_s, launches, setup_s=setup_s,
                  peak_bytes=peak)
    for m in cell.per_layer if trace else cell.end_to_end:
        v = read_metric(m["name"], ctx)
        if v is not None:
            result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    if trace:
        result["busy_s"] = prof.busy_ns() / 1e9
        result["window_s"] = prof_s
        ops = sorted(prof.by_name().items(), key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {"device_ops": [[n, ns / 1e9] for n, (_, ns) in ops],
                               "idle_gaps": prof.idle_gaps(STEP_SPAN)}
    result["memory_peak_bytes"] = peak
    result["log"].append("set-up seconds: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in phases.items()))
    result["log"].append(f"window: {steps} steps in {window_s:.4f} s "
                         f"({window_s / steps * 1e3:.2f} ms a step, {tokens} tokens a step), "
                         f"set-up {setup_s:.3f} s, peak {peak / 2**30:.3f} GiB")

    ctx = prog = metrics = None  # the program's state goes before the reference runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_readings(cell, seed, device)
    result["log"].append(f"reference: {time.perf_counter() - t_ref:.3f} s")
    checks = compare.checks(compare.numbers(got, want), cell.limits)
    result["correct"] = bool(finite and failed == 0 and compare.passes(checks))
    result["checks"] = checks
    result["log"].append(f"window losses finite: {finite}; steps the finite guard skipped: "
                         f"{failed}")
    result["log"].append("program losses " + " ".join(f"{v:.7f}" for v in got["losses"])
                         + "; reference " + " ".join(f"{v:.7f}" for v in want["losses"]))
    return result


def reference_readings(cell: Cell, seed: int, device: torch.device, *, fault: str | None = None,
                       tf32: bool = False) -> dict:
    """The plain reference's readings of the first :data:`CHECK_STEPS` steps
    from ``seed``; ``tf32`` computes its products in TF32 (the control)."""
    fam = weights.family(cell.model)
    specs = fam.param_specs(cell.model)
    n = int(cell.traffic["trainer"]["nodes"])
    pool = traffic_mod.pool(cell.traffic, int(cell.model["vocab_size"]), n, seed)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in pool[i % len(pool)].items()}
               for i in range(CHECK_STEPS)]
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        x0 = weights.make(specs, seed, device)
        return trainer_reference(cell).run(fam, cell.model, cell.traffic["trainer"], x0,
                                           batches, CHECK_STEPS, fault=fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
