"""A cell of ``BENCHMARK.json`` cut to a size that a CPU test holds: every
width and the vocabulary small, two layers, 32 tokens a row; the same
trainer, traffic rules and comparison."""

import copy

from bench import harness


def tiny_cell(name: str, limit: float = 1e-4) -> harness.Cell:
    cell = harness.load_cell(name)
    model = copy.deepcopy(cell.model)
    moe = "num_local_experts" in model
    model.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2 if moe else 4,
                 intermediate_size=32 if moe else 128, vocab_size=256, num_hidden_layers=2)
    if moe:
        model.update(num_local_experts=4, num_experts_per_tok=2)
    traffic = copy.deepcopy(cell.traffic)
    traffic.update(seq_len=32, rows_per_node=2 * int(traffic["trainer"].get("grad_accum", 1)),
                   profiled_steps=2)
    cell.model, cell.traffic = model, traffic
    cell.limits = {k: limit for k in cell.limits}
    return cell
