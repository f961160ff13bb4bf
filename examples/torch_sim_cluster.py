"""Drive a decentralized-training scenario through the PyTorch port's
cluster simulator, the counterpart of ``examples/sim_cluster.py``.

Examples::

    PYTHONPATH=src python examples/torch_sim_cluster.py --list
    PYTHONPATH=src python examples/torch_sim_cluster.py \\
        --scenario straggler_1slow --algorithm decentlam --topology ring
    PYTHONPATH=src python examples/torch_sim_cluster.py --device cpu \\
        --scenario failstop_quarter --algorithm dmsgd --steps 200

Prints the periodic trace (simulated time, per-node step range, consensus
distance, bias to the optimum), the run summary (per-node steps, stall
time, effective batch fraction, applied events) and a wall-clock projection
of the scenario on the NVIDIA H100's roofline (``repro_torch.sim.
wallclock``, the constants of ``repro_torch.launch.roofline.HW``).  The
iterates live on the card unless ``--device cpu``.  ``main(argv)`` returns
what it prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys

import torch

from repro_torch.core import (
    OptimizerConfig,
    bias_to_optimum,
    build_topology,
    make_linear_regression,
    make_optimizer,
)
from repro_torch.sim import SCENARIOS, SimSpec, get_scenario, project_wallclock, simulate
from repro_torch.utils import resolve_device

PROJECTION_LABEL = "wall-clock projection (NVIDIA H100 roofline, repro_torch.sim.wallclock)"


def main(argv=None) -> dict:
    """Run one scenario; returns ``{"trace", "summary", "projection", ...}``
    (``{"scenarios": ...}`` with ``--list``)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--scenario", default="straggler_1slow")
    parser.add_argument("--algorithm", default="decentlam")
    parser.add_argument("--topology", default="ring")
    parser.add_argument("--n", type=int, default=8)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--momentum", type=float, default=0.8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--record-dt", type=float, default=25.0)
    parser.add_argument("--engine", default="auto", choices=("auto", "vectorized", "pernode"),
                        help="event-loop strategy (vectorized scales to fleet-size n)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--list", action="store_true", help="list scenarios and exit")
    args = parser.parse_args(argv)

    if args.list:
        listed = {}
        for name in SCENARIOS:
            sc = get_scenario(name, args.n, args.steps)
            print(f"{name:24s} [{sc.engine:7s}] {sc.description}")
            listed[name] = sc.description
        return {"scenarios": listed}

    device = resolve_device(args.device)
    prob = make_linear_regression(n=args.n, m=50, d=30, noise=0.01, seed=0, heterogeneity=1.0,
                                  device=device)
    opt = make_optimizer(OptimizerConfig(algorithm=args.algorithm, momentum=args.momentum))
    metric = functools.partial(bias_to_optimum, x_star=prob.x_star)

    def restrict(indices):
        sel = torch.as_tensor(list(indices), device=device)
        sub = dataclasses.replace(prob, A=prob.A[sel], b=prob.b[sel])
        return lambda x, _s: sub.grad(x)

    print(f"scenario={args.scenario} algorithm={args.algorithm} "
          f"topology={args.topology} n={args.n} steps={args.steps} seed={args.seed}")
    spec = SimSpec(topology=args.topology, n=args.n, lr=args.lr, n_steps=args.steps,
                   scenario=args.scenario, seed=args.seed, record_dt=args.record_dt,
                   metric_fn=metric, restrict=restrict, engine=args.engine)
    res = simulate(opt, spec, torch.zeros((args.n, prob.dim), dtype=torch.float32,
                                          device=device),
                   lambda x, _s: prob.grad(x))

    trace = []
    print(f"\n{'sim_t':>8s} {'steps':>9s} {'consensus':>10s} {'bias':>10s}")
    for e in res.trace:
        rng = f"{e['min_step']}-{e['max_step']}"
        row = {"t": float(e["t"]), "min_step": int(e["min_step"]),
               "max_step": int(e["max_step"]), "consensus": float(e["consensus"]),
               "metric": float(e["metric"])}
        trace.append(row)
        print(f"{row['t']:8.1f} {rng:>9s} {row['consensus']:10.3e} {row['metric']:10.3e}")

    summary = res.summary()
    print("\nsummary:")
    for key, val in summary.items():
        print(f"  {key:26s} {val}")

    proj = project_wallclock(res, build_topology(args.topology, res.n_nodes), opt=opt)
    print(f"\n{PROJECTION_LABEL}:")
    for key in ("step_time_s", "dominant", "wallclock_s", "steps_per_s", "stall_s"):
        val = proj[key]
        print(f"  {key:26s} {val:.4g}" if isinstance(val, float) else f"  {key:26s} {val}")
    return {"trace": trace, "summary": summary, "projection": proj,
            "projection_label": PROJECTION_LABEL, "device": str(device)}


if __name__ == "__main__":
    main(sys.argv[1:])
