"""DeepSeek-V2-Lite on the port (``deepseek-v2-lite``) against the benchmark's
plain reference (``bench/reference/mla_moe.py``; the JAX package has no such
model), at small sizes on the CPU on seeded random weights:

* the MLA layer's output and gradients, with and without YaRN;
* the MoE layer with shared experts, raw gates and the sequence-level
  router term, output and gradients;
* the expert share: summed over every block of held experts, the blocks'
  routed parts, with the shared experts counted once, are the uncut layer;
* three DecentLaM steps of the smoke model through the benchmark's
  ``Program`` against ``harness.reference_readings`` (within 1e-4), and the
  two planted faults far above that;
* ``launch.train --arch deepseek-v2-lite --smoke`` against the reference's
  stacked trainer from the CLI's own initial parameters and batches;
* what stays refused (MLA at tp > 1 and serving), the configuration's
  parameter counts, and that granite's ``moe_forward`` and olmo's
  ``attention_core`` give the same bits as before the model came (the
  earlier bodies kept here as the oracle).
"""

import dataclasses
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench import compare, harness, reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import Initializer  # noqa: E402
from repro_torch.utils import tree_map  # noqa: E402

REF = reference.load("family", "mla_moe")
SMOKE = get_config("deepseek-v2-lite", smoke=True)
CPU = torch.device("cpu")


def ref_model(cfg, *, yarn: bool = True) -> dict:
    """The reference's configuration file for a port config."""
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "qk_nope_head_dim": cfg.qk_nope_head_dim, "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "kv_lora_rank": cfg.kv_lora_rank,
        "intermediate_size": cfg.d_ff, "moe_intermediate_size": cfg.moe_d_ff,
        "n_shared_experts": cfg.n_shared_experts, "n_routed_experts": cfg.n_experts_held,
        "num_experts_per_tok": cfg.top_k, "vocab_size": cfg.vocab_size,
        "first_k_dense_replace": cfg.first_dense_layers, "num_hidden_layers": cfg.n_layers,
        "rope_theta": cfg.rope_theta, "tie_word_embeddings": cfg.tie_embeddings,
        "aux_loss_alpha": cfg.router_aux_weight,
        "rope_scaling": ({"factor": cfg.yarn_factor, "beta_fast": cfg.yarn_beta_fast,
                          "beta_slow": cfg.yarn_beta_slow, "mscale": cfg.yarn_mscale,
                          "mscale_all_dim": cfg.yarn_mscale_all_dim,
                          "original_max_position_embeddings": cfg.yarn_original_max_pos}
                         if yarn else None),
        "run": {"norm": "rmsnorm", "router_width": cfg.n_experts,
                "capacity_factor": cfg.capacity_factor},
    }


def _grad_leaves(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(), tree)


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")


# YaRN as published; with mscale apart from mscale_all_dim (cos and sin
# scaled); none
YARN = {"yarn": {}, "yarn-mscale": {"yarn_mscale": 1.0}, "none": {"yarn_factor": 0.0}}


@pytest.mark.parametrize("case", sorted(YARN))
def test_mla_layer_and_grads_match_reference(case):
    cfg = dataclasses.replace(SMOKE, **YARN[case])
    yarn = case != "none"
    gen = torch.Generator().manual_seed(3)
    p = _grad_leaves(A.mla_init(Initializer(gen), cfg))
    p["kv_norm"] = (0.1 * torch.randn(cfg.kv_lora_rank, generator=gen)).requires_grad_()
    x = torch.randn(2, 24, cfg.d_model, generator=gen, requires_grad=True)
    w = torch.randn(2, 24, cfg.d_model, generator=gen)
    out = A.mla_forward(x, p, cfg)
    (out * w).sum().backward()

    m = REF.dims(ref_model(cfg, yarn=yarn))
    rp = {f"g.attn.{k}": v.detach().clone()[None].requires_grad_() for k, v in p.items()}
    rx = x.detach().clone().requires_grad_()
    want = REF.mla(rx, rp, "g", 0, m)
    (want * w).sum().backward()
    _close(out.detach(), want.detach(), "output")
    _close(x.grad, rx.grad, "d x")
    for k, v in p.items():
        _close(v.grad, rp[f"g.attn.{k}"].grad[0], f"d {k}")


def test_yarn_changes_the_rotation_and_the_scale():
    """YaRN's frequencies and softmax scale at the published sizes: the fast
    dims keep theta's frequency, the slow ones are divided by 40, and the
    scale is 192^-1/2 (0.1 0.707 ln 40 + 1)^2."""
    cfg = get_config("deepseek-v2-lite")
    freqs, cos_scale, scale = A.mla_rope(cfg)
    base = 1.0 / 10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert torch.equal(freqs[:10], base[:10])  # below floor(c(32)) = 10
    torch.testing.assert_close(freqs[23:], base[23:] / 40, rtol=1e-6, atol=0)  # ceil(c(1))
    assert cos_scale == 1.0
    assert scale == pytest.approx(192 ** -0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2,
                                  rel=1e-12)
    rfreqs, rcos, rscale = REF.yarn_freqs(REF.dims(ref_model(cfg)), CPU)
    torch.testing.assert_close(freqs, rfreqs, rtol=1e-6, atol=0)
    assert (rcos, rscale) == pytest.approx((cos_scale, scale), rel=1e-12)


def _moe_params(cfg, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return _grad_leaves(M.moe_init(Initializer(gen), cfg)), gen


def _ref_moe_params(p) -> dict:
    out = {f"groups.g1.moe.{k}": v for k, v in p.items() if k != "shared"}
    out.update({f"groups.g1.moe.shared.{k}": v for k, v in p["shared"].items()})
    return {k: v.detach().clone()[None].requires_grad_() for k, v in out.items()}


def test_moe_layer_with_shared_experts_and_raw_gates_matches_reference():
    cfg = dataclasses.replace(SMOKE, experts_held=4)
    p, gen = _moe_params(cfg)
    x = torch.randn(3, 16, cfg.d_model, generator=gen, requires_grad=True)
    w = torch.randn(3, 16, cfg.d_model, generator=gen)
    out, aux = M.moe_forward(x, p, cfg)
    (out * w).sum().backward()
    assert set(aux) == {"moe_load_balance", "moe_expert_hits"}  # no z-loss
    assert aux["moe_expert_hits"].shape == (4,)

    model = ref_model(cfg)
    rp = _ref_moe_params(p)
    rx = x.detach().clone().requires_grad_()
    want, balance = REF.moe_block(rx, rp, 0, model, REF.dims(model))
    (want * w).sum().backward()
    _close(out.detach(), want.detach(), "output")
    assert float(aux["moe_load_balance"].detach()) == pytest.approx(float(balance.detach()),
                                                                 rel=1e-6)
    _close(x.grad, rx.grad, "d x")
    for k, v in rp.items():
        leaf = p["shared"][k.split(".")[-1]] if ".shared." in k else p[k.split(".")[-1]]
        _close(leaf.grad, v.grad[0], f"d {k}")
    # the raw gates: a token's kept gates sum to its top-k probabilities, under 1
    _, probs, idx, gates = M.route(x.detach().reshape(-1, cfg.d_model), p["router"], cfg)
    assert torch.equal(gates, torch.gather(probs, 1, idx)) and float(gates.sum(1).max()) < 1


def test_expert_blocks_sum_to_the_uncut_layer():
    """Eight chips of 2 experts each of 16: each block's routed part (its
    output less the shared experts, which every chip computes alike), summed
    over the blocks, plus the shared experts once, is the reference's layer
    holding all 16."""
    whole = dataclasses.replace(SMOKE, n_experts=16)
    p, gen = _moe_params(whole, seed=11)
    x = torch.randn(2, 32, whole.d_model, generator=gen)
    model = ref_model(whole)
    want, _ = REF.moe_block(x, _ref_moe_params(p), 0, model, REF.dims(model))

    cut = dataclasses.replace(whole, experts_held=2)
    shared = T.mlp_apply(x, p["shared"], cut.act)
    total = shared.clone()
    for b in range(8):
        block = dict(p, **{k: p[k][2 * b:2 * b + 2] for k in ("w_in", "w_gate", "w_out")})
        out, aux = M.moe_forward(x, block, cut, block=b)
        total = total + (out - shared)
        assert aux["moe_expert_hits"].shape == (2,)
    _close(total.detach(), want.detach(), "the blocks' sum")


def _tiny_cell():
    """The benchmark's cell at the smoke model's sizes: 4 of its 8 experts
    held, 2 rows of 32 tokens a node."""
    cell = harness.load_cell("deepseek-v2-lite.l7.e8.b4k")
    model = dict(cell.model, hidden_size=SMOKE.d_model, num_attention_heads=SMOKE.n_heads,
                 num_key_value_heads=SMOKE.n_kv_heads, intermediate_size=SMOKE.d_ff,
                 moe_intermediate_size=SMOKE.moe_d_ff, kv_lora_rank=SMOKE.kv_lora_rank,
                 qk_nope_head_dim=SMOKE.qk_nope_head_dim,
                 qk_rope_head_dim=SMOKE.qk_rope_head_dim, v_head_dim=SMOKE.v_head_dim,
                 vocab_size=SMOKE.vocab_size, num_hidden_layers=SMOKE.n_layers,
                 n_routed_experts=4, num_experts_per_tok=SMOKE.top_k,
                 run=dict(cell.model["run"], router_width=SMOKE.n_experts))
    cell.model = model
    cell.traffic = dict(cell.traffic, seq_len=32, rows_per_node=2)
    cell.limits = {k: 1e-4 for k in cell.limits}
    return cell


def test_smoke_model_through_the_benchmark_matches_reference():
    cell = _tiny_cell()
    assert harness.program_config(cell.model) == dataclasses.replace(SMOKE, experts_held=4)
    prog = harness.Program(cell, 2**31 + 5, CPU, "torch")
    got = prog.check_steps()
    del prog
    want = harness.reference_readings(cell, 2**31 + 5, CPU)
    numbers = compare.numbers(got, want)
    assert set(cell.limits) == set(numbers)
    assert all(v < 1e-4 for v in numbers.values()), numbers
    for fault in ("half_batch", "no_exchange"):
        bad = compare.numbers(harness.reference_readings(cell, 2**31 + 5, CPU, fault=fault),
                              want)
        assert max(bad.values()) > 1e-2, (fault, bad)


def test_cli_trains_the_smoke_model_as_the_reference():
    """``launch.train --arch deepseek-v2-lite --smoke --flat-planes`` on the
    CPU, 4 nodes, 3 steps: each step's loss against the reference's stacked
    DecentLaM trainer from the CLI's initial parameters and batches."""
    n, per_node, seq, steps = 4, 2, 16, 3
    res = tlaunch.main(["--nodes", str(n), "--arch", "deepseek-v2-lite", "--smoke",
                        "--steps", str(steps), "--seq-len", str(seq), "--per-node-batch",
                        str(per_node), "--lr", "0.05", "--warmup", "1", "--fused-update",
                        "--flat-planes", "--device", "cpu", "--log-every", "1"])
    x0 = harness.leaves(T.init_params(SMOKE, torch.Generator().manual_seed(0)))
    data = SyntheticLM(SyntheticLMConfig(vocab_size=SMOKE.vocab_size, seq_len=seq,
                                         per_node_batch=per_node, n_nodes=n,
                                         heterogeneity=0.2))
    batches = [{k: torch.as_tensor(v) for k, v in data.batch(k).items()}
               for k in range(steps)]
    trainer = {"nodes": n, "algorithm": "decentlam", "topology": "exp", "compression": None,
               "momentum": 0.9, "grad_accum": 1,
               "schedule": {"kind": "warmup_cosine", "peak_lr": 0.05, "warmup_steps": 1,
                            "total_steps": steps}}
    want = reference.load("algorithm", "decentlam").run(REF, ref_model(SMOKE), trainer, x0,
                                                        batches, steps)
    assert res["losses"] == pytest.approx(want["losses"], rel=1e-5)
    assert all(v > 0 for v in res["moe_load_balance"]) and res["moe_router_z"] == [0.0] * steps


def test_mla_is_refused_at_tp_above_1_and_in_serving():
    for call in (lambda: T.check_tp(SMOKE, 2), lambda: T.param_shard_axes(SMOKE, 2)):
        with pytest.raises(NotImplementedError, match="no tensor-parallel path"):
            call()
    for call in (lambda: T.check_tp(SMOKE, 1, serve=True),
                 lambda: T.init_cache(SMOKE, 1, 8, T.RuntimeConfig(), device="meta"),
                 lambda: T.prefill(T.init_params(SMOKE, torch.Generator().manual_seed(0)),
                                   {"tokens": torch.zeros((1, 4), dtype=torch.long)}, SMOKE,
                                   T.RuntimeConfig(dtype="float32"))):
        with pytest.raises(NotImplementedError, match="latent kv cache and decode step"):
            call()
    T.check_tp(SMOKE, 1)  # trains at tp = 1


def test_configuration_counts():
    """The published model (15.7 B parameters) and the benchmark's cut: 7
    layers, 8 of 64 experts, 12,800 vocabulary rows, 735,872,512 a node; the
    count is what ``init_params`` holds, and the groups are one dense layer
    then the MoE layers."""
    full = get_config("deepseek-v2-lite")
    cut = harness.program_config(harness.load_cell("deepseek-v2-lite.l7.e8.b4k").model)
    assert cut == dataclasses.replace(full, n_layers=7, experts_held=8, vocab_size=12800)
    for cfg, n in ((full, 15_706_484_224), (cut, 735_872_512), (SMOKE, None)):
        held = T.count_params(T.init_params(cfg, torch.Generator(), device="meta"))
        assert cfg.param_count() == held and (n is None or held == n)
    assert [(g.kind, g.layers) for g in T.block_groups(cut)] == [("dense", (0,)),
                                                                 ("moe", tuple(range(1, 7)))]
    # at tp = 1 the shard axes name every leaf the model holds
    assert set(harness.leaves(T.param_shard_axes(SMOKE, 1))) == set(
        harness.leaves(T.init_params(SMOKE, torch.Generator(), device="meta")))
    # a token takes the shared experts, the router and 6 of the 64 experts
    expert = 3 * 2048 * 1408
    assert full.active_param_count() == full.param_count() - 26 * (64 - 6) * expert


# ---------------------------------------------------------------------------
# granite's MoE layer and olmo's attention core: the same bits as before
# (their bodies before latent attention and held experts came, kept here)
# ---------------------------------------------------------------------------


def _attention_core_before(q, k, v, *, causal, window=0, softcap=0.0):
    H = q.shape[2]
    k, v = A._group_full(k, H), A._group_full(v, H)
    Sq, Sk, hd = q.shape[1], k.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, torch.full((), A.NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _moe_forward_before(x, params, cfg):
    B, S, d = x.shape
    dt, E, T_ = x.dtype, cfg.n_experts, B * S
    xt = x.reshape(T_, d)
    logits = xt.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
    gate_vals = torch.gather(probs, 1, expert_idx)
    gate_vals = gate_vals / torch.clamp(torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    me = torch.mean(probs, dim=0)
    onehot = torch.zeros((T_, E), dtype=torch.float32, device=x.device)
    onehot.scatter_(1, expert_idx, 1.0)
    ce = torch.mean(onehot, dim=0)
    aux = {"moe_load_balance": E * torch.sum(me * ce),
           "moe_router_z": torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))}
    tabs = M.dispatch_tables(expert_idx, gate_vals, cfg)
    C, table, slots, gtable = tabs["capacity"], tabs["table"], tabs["slots"], tabs["gtable"]
    aux["moe_expert_hits"] = tabs["hits"]
    E_local = params["w_in"].shape[0]
    xin = M._Dispatch.apply(xt, table, slots).reshape(E_local, C, d)
    h = torch.bmm(xin, params["w_in"].to(dt))
    h = M._ACTS[cfg.act](torch.bmm(xin, params["w_gate"].to(dt))) * h
    y = torch.bmm(h, params["w_out"].to(dt)) * gtable.reshape(E_local, C, 1).to(dt)
    out = M._Combine.apply(y.reshape(E_local * C, d).to(torch.float32), table, slots)
    return out.reshape(B, S, d).to(dt), aux


def test_granite_moe_and_olmo_attention_give_the_same_bits_as_before():
    gen = torch.Generator().manual_seed(17)
    olmo = get_config("olmo-1b", smoke=True)
    q, k, v = (torch.randn(2, 20, olmo.n_heads, olmo.hd, generator=gen) for _ in range(3))
    for window in (0, 7):
        assert torch.equal(A.attention_core(q, k, v, causal=True, window=window),
                           _attention_core_before(q, k, v, causal=True, window=window))

    granite = get_config("granite-moe-1b-a400m", smoke=True)
    p, _ = _moe_params(granite, seed=19)
    x = torch.randn(3, 16, granite.d_model, generator=gen)
    w = torch.randn(3, 16, granite.d_model, generator=gen)
    runs = []
    for fn in (lambda x, p: M.moe_forward(x, p, granite),
               lambda x, p: _moe_forward_before(x, p, granite)):
        pp, xx = _grad_leaves(p), x.clone().requires_grad_()
        out, aux = fn(xx, pp)
        (out * w).sum().backward()
        runs.append((out, aux, xx.grad, {kk: vv.grad for kk, vv in pp.items()}))
    (out, aux, gx, gp), (out0, aux0, gx0, gp0) = runs
    assert torch.equal(out, out0) and torch.equal(gx, gx0)
    assert set(aux) == set(aux0) and all(torch.equal(aux[kk], aux0[kk]) for kk in aux)
    assert set(gp) == set(gp0) and all(torch.equal(gp[kk], gp0[kk]) for kk in gp)
