"""End-to-end decentralized LM training on the PyTorch port, the
counterpart of ``examples/train_lm.py``.

A thin wrapper over ``repro_torch.launch.train``: 8 decentralized nodes,
one process each (``--simulate-nodes 8``: on one card the ranks share it
over gloo), DecentLaM on the exponential graph, periodic checkpoints, and a
fail-stop drill (gather -> shrink to 4 nodes -> elastic resume) half way
through — the fault-tolerance story in one run.

Run:    PYTHONPATH=src python examples/torch_train_lm.py --ckpt-dir build/train_lm
        PYTHONPATH=src python examples/torch_train_lm.py --ckpt-dir build/train_lm \\
            --device cpu --steps 20          # on the host CPU, fewer steps
Scale:  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m \\
            --simulate-nodes 8 --steps 300

Any further flag goes to the trainer after the example's own (a later
``--steps`` wins).  ``main(argv)`` returns the trainer's result (rank 0's).
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.launch import train

ARGV = [
    "--simulate-nodes", "8",
    "--preset", "tiny",
    "--steps", "120",
    "--algorithm", "decentlam",
    "--topology", "exp",
    "--seq-len", "128",
    "--per-node-batch", "4",
    "--ckpt-every", "50",
    "--failure-drill",
    "--log-every", "20",
]
DEFAULT_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "build",
                            "train_lm_ckpt")


def argv_of(argv=None) -> list[str]:
    """The trainer's argv for this example's ``argv``."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt-dir", dest="ckpt_dir", default=DEFAULT_CKPT,
                   help="where the checkpoints go (default: build/train_lm_ckpt in the "
                   "checkout)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, rest = p.parse_known_args(argv)
    return ARGV + ["--ckpt-dir", os.path.normpath(args.ckpt_dir), "--device", args.device] + rest


def main(argv=None, **hooks) -> dict:
    """Run the trainer (``hooks`` go to ``repro_torch.launch.train.main``)."""
    return train.main(argv_of(argv), **hooks)


if __name__ == "__main__":
    main(sys.argv[1:])
