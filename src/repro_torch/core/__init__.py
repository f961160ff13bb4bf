"""DecentLaM core: topologies, gossip executors, decentralized optimizers,
and the stacked oracle of the paper's bias experiments (the port of
``repro.core``; its exports, from the same place)."""

from .compression import Compressor, get_compressor, wire_bytes
from .gossip import (
    AllgatherChannel,
    DelayedPpermuteChannel,
    DelayedStackedChannel,
    GossipChannel,
    PpermuteChannel,
    StackedChannel,
    build_channel,
    delay_matrix,
    gossip_bytes_per_step,
    make_psum_mean,
    make_stacked_mean,
)
from .optimizers import ALGORITHMS, Optimizer, OptimizerConfig, make_optimizer
from .planes import PlaneLayout, plane_scalars
from .reference import (
    LinearRegressionProblem,
    bias_to_optimum,
    consensus_distance,
    make_linear_regression,
    run_bias_experiment,
    run_stacked,
)
from .schedules import (
    ScheduleConfig,
    build_schedule,
    linear_scaled_lr,
    warmup_cosine,
    warmup_step_decay,
)
from .topology import (
    TOPOLOGIES,
    EdgeClass,
    Topology,
    TopologySpec,
    build_topology,
    metropolis_weights,
    rho,
)

__all__ = [
    "ALGORITHMS",
    "AllgatherChannel",
    "Compressor",
    "DelayedPpermuteChannel",
    "DelayedStackedChannel",
    "EdgeClass",
    "GossipChannel",
    "PpermuteChannel",
    "StackedChannel",
    "LinearRegressionProblem",
    "Optimizer",
    "OptimizerConfig",
    "PlaneLayout",
    "ScheduleConfig",
    "TOPOLOGIES",
    "Topology",
    "TopologySpec",
    "bias_to_optimum",
    "build_channel",
    "build_schedule",
    "build_topology",
    "consensus_distance",
    "delay_matrix",
    "get_compressor",
    "gossip_bytes_per_step",
    "linear_scaled_lr",
    "make_linear_regression",
    "make_optimizer",
    "make_psum_mean",
    "make_stacked_mean",
    "metropolis_weights",
    "plane_scalars",
    "rho",
    "run_bias_experiment",
    "run_stacked",
    "wire_bytes",
]
