"""Reproduce the paper's Figs. 2-3 on the PyTorch port (App. G.2 linear
regression), the counterpart of ``examples/bias_demo.py``.

Run:  PYTHONPATH=src python examples/torch_bias_demo.py               # on the card
      PYTHONPATH=src python examples/torch_bias_demo.py --device cpu

``--scenario NAME`` regenerates the same bias figures under a non-ideal
cluster through the port's discrete-event simulator (``repro_torch.sim``),
e.g. ``--scenario straggler_1slow`` or ``--scenario stale_gossip_k2``.

``--gossip-delay K --compression C`` instead swaps the transport under the
synchronous harness: a ``DelayedStackedChannel`` mixes iterates K rounds
old, optionally through a message compressor.

Default (no scenario, delay 0) is the idealized synchronous lockstep of
``run_stacked``.  ``main(argv)`` returns what it prints.
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from repro_torch.core import (
    DelayedStackedChannel,
    OptimizerConfig,
    bias_to_optimum,
    build_topology,
    make_linear_regression,
    make_optimizer,
    run_bias_experiment,
)
from repro_torch.utils import resolve_device

ALGOS = ("dsgd", "dmsgd", "decentlam")


def main(argv=None) -> dict:
    """Run the bias study; returns ``{"ticks", "traces" (per algorithm),
    "amplification" (DmSGD / DSGD), "ratio" (DecentLaM / DSGD), ...}``."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--scenario", default=None,
                        help="route through the cluster simulator (see repro_torch.sim."
                        "SCENARIOS); default: idealized synchronous lockstep")
    parser.add_argument("--seed", type=int, default=0, help="scenario clock seed")
    parser.add_argument("--gossip-delay", dest="gossip_delay", type=int, default=0,
                        help="mix iterates K rounds old via a DelayedStackedChannel "
                        "(synchronous harness; mutually exclusive with --scenario)")
    parser.add_argument("--compression", default=None,
                        help="message compressor for the channel (bf16 | int8 | topk:R)")
    parser.add_argument("--steps", type=int, default=3000, help="steps of each study")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.scenario is not None and (args.gossip_delay or args.compression):
        parser.error("--gossip-delay/--compression drive the synchronous channel path and "
                     "would be ignored by the simulator; use stale_gossip_k* scenarios for "
                     "simulated staleness")
    device = resolve_device(args.device)

    prob = make_linear_regression(n=8, m=50, d=30, noise=0.01, seed=0, device=device)
    topo = build_topology("torus", 8)
    n_steps, record, lr, momentum = args.steps, 300, 1e-3, 0.8
    print(f"8-node mesh topology, rho = {topo.rho():.3f}, b^2 = {prob.b_sq:.1f}")

    if args.scenario is None:
        channel = None
        if args.gossip_delay or args.compression:
            channel = DelayedStackedChannel(topo, args.gossip_delay,
                                            compression=args.compression)
            print(f"transport: {channel.name} channel, delay={args.gossip_delay}, "
                  f"compression={args.compression}")
        print()
        traces = {a: run_bias_experiment(a, prob, topo, lr=lr, momentum=momentum,
                                         n_steps=n_steps, record_every=record,
                                         channel=channel)
                  for a in ALGOS}
        label = {a: [float(v) for v in traces[a]] for a in ALGOS}
        ticks = [i * record for i in range(len(label["dsgd"]))]
    else:
        from repro_torch.sim import SimSpec, simulate

        metric = functools.partial(bias_to_optimum, x_star=prob.x_star)
        print(f"scenario: {args.scenario} (seed {args.seed})\n")
        label = {}
        for a in ALGOS:
            opt = make_optimizer(OptimizerConfig(algorithm=a, momentum=momentum))
            res = simulate(
                opt,
                SimSpec(topology="torus", n=8, lr=lr, n_steps=n_steps,
                        scenario=args.scenario, seed=args.seed, record_dt=float(record),
                        metric_fn=metric),
                torch.zeros((8, prob.dim), dtype=torch.float32, device=device),
                lambda x, _s: prob.grad(x),
            )
            label[a] = [float(e["metric"]) for e in res.trace]
        ticks = [e["t"] for e in res.trace]
        shortest = min(len(v) for v in label.values())
        ticks = ticks[:shortest]
        label = {a: v[:shortest] for a, v in label.items()}

    print(f"{'step':>6s}  {'DSGD':>10s}  {'DmSGD':>10s}  {'DecentLaM':>10s}")
    for i, tick in enumerate(ticks):
        print(f"{int(tick):6d}  {label['dsgd'][i]:10.3e}  {label['dmsgd'][i]:10.3e}"
              f"  {label['decentlam'][i]:10.3e}")

    amp = label["dmsgd"][-1] / label["dsgd"][-1]
    ratio = label["decentlam"][-1] / label["dsgd"][-1]
    print(f"\nDmSGD bias amplification: {amp:.1f}x "
          f"(Prop. 2 predicts up to 1/(1-0.8)^2 = 25x)")
    print(f"DecentLaM / DSGD bias ratio: {ratio:.2f} (Prop. 3 predicts ~1)")
    return {"ticks": [int(t) for t in ticks], "traces": label, "amplification": amp,
            "ratio": ratio, "rho": topo.rho(), "b_sq": prob.b_sq, "device": str(device)}


if __name__ == "__main__":
    main(sys.argv[1:])
