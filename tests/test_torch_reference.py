"""The stacked oracle and the paper's bias experiments in the port against
the JAX package, on the CPU: ``run_stacked`` for each of the eleven
algorithms, through a delayed and a compressed channel too; the App. G.2
linear-regression data (the same arrays, bit for bit); and the bounds of
``tests/test_bias_propositions.py`` (Props. 1-3, Figs. 2-3) at reduced
steps, beside the reference's own values at those steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.interop import to_numpy
from repro_torch.utils import tree_leaves

N, M, D = 8, 10, 6
LR, BETA = 1e-2, 0.8
STEPS = 100
# run_stacked vs the reference, of each leaf's max |value|: both iterate in
# f32, and XLA and torch round each step's sums in their own order
RUN_RTOL = 1e-4
# optimizer state, absolutely: a gradient estimator that differences
# iterates ((x - mix) / lr in DecentLaM, the exact mean's in PmSGD) carries
# their f32 roundoff amplified by 1/lr, so 10 ulps of max |x| over lr
STATE_ULPS = 10 * 2.0**-23
# the final bias of the reduced bias runs, port vs reference
BIAS_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one intra-op thread, so that parallel test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(**kw):
    args = dict(n=N, m=M, d=D, noise=0.01, seed=1, heterogeneity=1.0) | kw
    return jcore.make_linear_regression(**args), tcore.make_linear_regression(
        **args, device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _close(got, want, what, atol=0.0):
    got, want = tree_leaves(to_numpy(got)), jax.tree.leaves(jax.device_get(want))
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, what
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        assert err < atol or _rel(g, w) < RUN_RTOL, (what, err, _rel(g, w))


def _state_atol(wp, lr=LR):
    return STATE_ULPS * float(np.max(np.abs(np.asarray(wp)))) / lr


def test_core_exports_match_the_reference():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None


def test_linear_regression_data_equal_the_references_bit_for_bit():
    """default_rng(seed) in the reference's order, rounded to f32 once: the
    same A, b and x*; the same b^2 and smoothness; grad and loss agree."""
    for kw in ({}, dict(n=8, m=50, d=30, seed=0), dict(heterogeneity=0.3, noise=0.5, seed=7)):
        jp, tp = _problems(**kw)
        for name in ("A", "b", "x_star"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)), err_msg=name)
            assert getattr(tp, name).dtype == torch.float32
        assert tp.b_sq == jp.b_sq and (tp.n, tp.dim) == (jp.n, jp.dim)
        assert tp.smoothness() == jp.smoothness()
        x = np.random.default_rng(3).standard_normal((tp.n, tp.dim)).astype(np.float32)
        assert _rel(tp.grad(torch.from_numpy(x)), jp.grad(jnp.asarray(x))) < 1e-6
        assert _rel(tp.loss(torch.from_numpy(x[0])), jp.loss(jnp.asarray(x[0]))) < 1e-6
        assert _rel(tcore.consensus_distance(torch.from_numpy(x)),
                    jcore.consensus_distance(jnp.asarray(x))) < 1e-6
        assert _rel(tcore.bias_to_optimum(torch.from_numpy(x), tp.x_star),
                    jcore.bias_to_optimum(jnp.asarray(x), jp.x_star)) < 1e-6


def _both(algorithm, topology="exp", channels=None, lr=LR, steps=STEPS):
    jp, tp = _problems()
    jopt = jcore.make_optimizer(jcore.OptimizerConfig(algorithm=algorithm, momentum=BETA))
    topt = tcore.make_optimizer(tcore.OptimizerConfig(algorithm=algorithm, momentum=BETA))
    jch, tch = channels if channels is not None else (None, None)
    want = jcore.run_stacked(
        jopt, jcore.build_topology(topology, N), jnp.zeros((N, D), jnp.float32),
        lambda x, _s: jp.grad(x), lr=lr, n_steps=steps, record_every=10,
        metric_fn=lambda x: jcore.bias_to_optimum(x, jp.x_star), channel=jch)
    got = tcore.run_stacked(
        topt, tcore.build_topology(topology, N), torch.zeros((N, D)),
        lambda x, _s: tp.grad(x), lr=lr, n_steps=steps, record_every=10,
        metric_fn=lambda x: tcore.bias_to_optimum(x, tp.x_star), channel=tch)
    return got, want


@pytest.mark.parametrize("algorithm", tcore.ALGORITHMS)
def test_run_stacked_matches_the_reference(algorithm):
    """100 full-batch steps on exp (n 8): the final parameters, every
    optimizer-state bucket (at the state tolerance) and the metric trace
    (steps 0, 10, .., 90, 99)."""
    (p, s, tr), (wp, ws, wtr) = _both(algorithm)
    _close(p, wp, "params")
    assert sorted(s) == sorted(ws)
    for k in s:
        _close(s[k], ws[k], k, _state_atol(wp))
    assert tr.shape == wtr.shape == (11,)
    assert _rel(tr, wtr) < RUN_RTOL


def test_run_stacked_takes_a_schedule_and_a_time_varying_topology():
    """``lr`` as a step -> lr schedule (the reference traces it with a jnp
    step; the port calls it with the int), on one-peer-exp."""
    sched = lambda s: 1e-2 / (1.0 + 0.01 * s)  # noqa: E731
    (p, _, tr), (wp, _, wtr) = _both("dmsgd", "one-peer-exp", lr=sched)
    _close(p, wp, "params")
    assert _rel(tr, wtr) < RUN_RTOL


@pytest.mark.parametrize("kind", ["delay-1", "delay-2-da", "int8", "topk-ef"])
def test_run_stacked_through_delayed_and_compressed_channels(kind):
    """The channel's state (the delay ring, error-feedback residuals) is
    threaded through the steps, as in the reference; decentlam-sa reads its
    gaps from the delayed channel."""
    algorithm = {"delay-1": "decentlam-sa", "delay-2-da": "da-dmsgd"}.get(kind, "decentlam")
    calls = 2 if algorithm == "da-dmsgd" else 1
    jt, tt = jcore.build_topology("ring", N), tcore.build_topology("ring", N)
    if kind.startswith("delay"):
        delay = int(kind.split("-")[1])
        channels = (jcore.DelayedStackedChannel(jt, delay, calls_per_step=calls),
                    tcore.DelayedStackedChannel(tt, delay, calls_per_step=calls))
    else:
        comp = {"int8": "int8", "topk-ef": "topk:0.5"}[kind]
        channels = (jcore.StackedChannel(jt, compression=comp),
                    tcore.StackedChannel(tt, compression=comp))
    (p, s, tr), (wp, ws, wtr) = _both(algorithm, "ring", channels, steps=40)
    _close(p, wp, f"params ({kind})")
    for k in s:
        _close(s[k], ws[k], f"{k} ({kind})", _state_atol(wp))
    assert _rel(tr, wtr) < RUN_RTOL


def test_run_stacked_needs_a_metric_to_record():
    _, tp = _problems()
    opt = tcore.make_optimizer(tcore.OptimizerConfig(algorithm="dsgd"))
    with pytest.raises(ValueError, match="metric_fn"):
        tcore.run_stacked(opt, tcore.build_topology("ring", N), torch.zeros((N, D)),
                          lambda x, _s: tp.grad(x), lr=LR, n_steps=2, record_every=1)


# ---------------------------------------------------------------------------
# The paper's bias propositions (tests/test_bias_propositions.py), reduced
# ---------------------------------------------------------------------------

BIAS_LR, BIAS_STEPS = 1e-3, 2000


def _bias(pkg, algo, lr=BIAS_LR, steps=BIAS_STEPS):
    if pkg is jcore:
        prob = jcore.make_linear_regression(n=8, m=50, d=30, noise=0.01, seed=0)
    else:
        prob = tcore.make_linear_regression(n=8, m=50, d=30, noise=0.01, seed=0, device="cpu")
    return float(pkg.run_bias_experiment(algo, prob, pkg.build_topology("torus", 8), lr=lr,
                                         momentum=BETA, n_steps=steps,
                                         record_every=steps)[-1])


def test_fig2_and_props_2_3_bias_bounds_at_reduced_steps():
    """Fig. 2: DmSGD's bias > 3x DSGD's; Prop. 2: the ratio within 10x of
    1/(1-beta)^2 = 25; Prop. 3: DecentLaM's < 1.5x DSGD's and < 0.2x
    DmSGD's — on the paper's 8-node torus at 2,000 of the reference test's
    4,000 steps, each final bias beside the reference's at those steps."""
    got = {a: _bias(tcore, a) for a in ("dsgd", "dmsgd", "decentlam")}
    want = {a: _bias(jcore, a) for a in got}
    for a in got:
        assert abs(got[a] - want[a]) <= BIAS_RTOL * want[a], (a, got[a], want[a])
    assert got["dmsgd"] > 3.0 * got["dsgd"]
    ratio, predicted = got["dmsgd"] / got["dsgd"], 1.0 / (1.0 - BETA) ** 2
    assert predicted / 10 < ratio < predicted * 10, ratio
    assert got["decentlam"] < 1.5 * got["dsgd"] and got["decentlam"] < 0.2 * got["dmsgd"]


def test_bias_scales_with_gamma_squared_at_reduced_steps():
    b1, b2 = _bias(tcore, "decentlam"), _bias(tcore, "decentlam", lr=2 * BIAS_LR)
    assert 2.0 < b2 / b1 < 8.0, b2 / b1


def test_prop1_large_batch_regime_at_reduced_steps():
    """Prop. 1: with no gradient noise DmSGD's error over DecentLaM's > 2;
    with sigma = 50 the gap shrinks.  The noise comes from one numpy stream,
    as in the reference test."""
    rng = np.random.default_rng(0)
    prob = tcore.make_linear_regression(n=8, seed=0, device="cpu")
    topo = tcore.build_topology("torus", 8)

    def final_err(algo, sigma):
        opt = tcore.make_optimizer(tcore.OptimizerConfig(algorithm=algo, momentum=BETA))

        def grad(x, _step):
            noise = torch.as_tensor(rng.standard_normal((8, prob.dim)), dtype=torch.float32)
            return prob.grad(x) + sigma * noise

        x, _, _ = tcore.run_stacked(opt, topo, torch.zeros((8, prob.dim)), grad, lr=BIAS_LR,
                                    n_steps=1500)
        return float(torch.mean(torch.sum((x - prob.x_star[None]) ** 2, dim=-1)))

    gap_fullbatch = final_err("dmsgd", 0.0) / final_err("decentlam", 0.0)
    gap_noisy = final_err("dmsgd", 50.0) / final_err("decentlam", 50.0)
    assert gap_fullbatch > 2.0
    assert gap_noisy < gap_fullbatch


def test_decentlam_fixed_point_eq51():
    """DecentLaM's limit satisfies (I - W) x = -gamma W grad f(x) (eq. 51)."""
    prob = tcore.make_linear_regression(n=8, seed=0, device="cpu")
    topo = tcore.build_topology("torus", 8)
    opt = tcore.make_optimizer(tcore.OptimizerConfig(algorithm="decentlam", momentum=BETA))
    x, _, _ = tcore.run_stacked(opt, topo, torch.zeros((8, prob.dim)),
                                lambda xx, s: prob.grad(xx), lr=BIAS_LR, n_steps=6000)
    W = torch.as_tensor(topo.W(0), dtype=torch.float32)
    lhs = (torch.eye(8) - W) @ x
    rhs = -BIAS_LR * (W @ prob.grad(x))
    resid = float(torch.max(torch.abs(lhs - rhs)))
    scale = float(torch.max(torch.abs(lhs))) + 1e-12
    assert resid / max(scale, 1e-8) < 0.05 or resid < 1e-6, (resid, scale)
