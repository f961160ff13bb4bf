"""Quickstart on the PyTorch port: DecentLaM vs DmSGD on 8 stacked nodes,
the counterpart of ``examples/quickstart.py``.

Trains a tiny LM with both algorithms on heterogeneous synthetic shards and
prints the loss + consensus distance — DecentLaM reaches a lower loss floor
because its inconsistency bias is not momentum-amplified (paper Prop. 2-3).

The 8 node replicas are stacked on one device and gossip through the
stacked ``W @`` channel, whose state (telemetry here) lives in the
TrainState's ``"channel"`` bucket; the channel's introspection prices the
wire traffic one node would send (``bytes_per_step``).

Run:  PYTHONPATH=src python examples/torch_quickstart.py               # on the card
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu

``main(argv)`` returns what it prints.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import tiny_lm
from repro_torch.core.optimizers import make_optimizer
from repro_torch.core.schedules import ScheduleConfig
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig
from repro_torch.models.transformer import RuntimeConfig, count_params
from repro_torch.train.step import TrainConfig, build_train_step
from repro_torch.train.train_state import init_train_state
from repro_torch.utils import resolve_device

N_NODES, STEPS, SEQ = 8, 60, 64
CONFIG = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=1024)
ALGOS = ("dmsgd", "decentlam")


def train_config(algorithm: str) -> TrainConfig:
    """The quickstart's training configuration for ``algorithm``."""
    return TrainConfig(algorithm=algorithm, topology="exp", momentum=0.9,
                       schedule=ScheduleConfig(kind="constant", peak_lr=5e-3),
                       runtime=RuntimeConfig(dtype="float32"), track_consensus=True)


def data_config(cfg) -> SyntheticLMConfig:
    return SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, per_node_batch=4,
                             n_nodes=N_NODES, heterogeneity=0.5)


def main(argv=None) -> dict:
    """Train both algorithms; returns ``{algorithm: {"losses", "consensus_sq",
    "egress_bytes", "hops", "rounds", "telemetry_bytes"}}``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = tiny_lm(**CONFIG)
    out: dict = {}
    for algo in ALGOS:
        tcfg = train_config(algo)
        opt = make_optimizer(tcfg.opt_config())
        step_fn, channel = build_train_step(cfg, tcfg, N_NODES)
        state = init_train_state(cfg, opt, N_NODES, device=device, channel=channel)
        n_params = count_params(state["params"]) // N_NODES
        comm = channel.bytes_per_step(4.0 * n_params)
        print(f"{algo}: {channel.name} channel on {channel.topology.name}, "
              f"{comm['egress_bytes'] / 2**20:.1f} MiB egress/node/step "
              f"over {comm['hops']:.0f} hops")
        data = SyntheticLM(data_config(cfg))
        losses, consensus = [], []
        for k in range(args.steps):
            batch = {key: torch.from_numpy(v).to(device) for key, v in data.batch(k).items()}
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            consensus.append(float(m["consensus_sq"]))
            if k % 20 == 0 or k == args.steps - 1:
                print(f"{algo:10s} step {k:3d} loss {losses[-1]:.4f} "
                      f"consensus {consensus[-1]:.3e}")
        tele = state["channel"]["t"]
        rounds, sent = int(tele["rounds"]), float(tele["bytes"])
        print(f"{algo:10s} channel telemetry: {rounds} gossip rounds, "
              f"{sent / 2**20:.1f} MiB egress/node\n")
        out[algo] = {"losses": losses, "consensus_sq": consensus,
                     "egress_bytes": comm["egress_bytes"], "hops": comm["hops"],
                     "rounds": rounds, "telemetry_bytes": sent}
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
