"""Model config dataclass (a copy of ``repro.configs.base.ModelConfig``,
extended for the models the JAX package does not have: DeepSeek-V2's latent
attention (MLA) and YaRN rope, shared experts, leading dense layers, a
chip's block of experts and ungated or sequence-level routers;
:data:`EXTENSION_FIELDS`).

Every architecture file (``configs/<id>.py``) exports a ``CONFIG`` (exact
published dims) and a ``SMOKE`` (reduced same-family config for CPU tests).
The input-shape registry (``ShapeSpec``, ``SHAPES``, ``shape_applicable``)
is a copy of ``repro.configs.base``'s: the dry run's cells.
"""

from __future__ import annotations

import dataclasses

__all__ = ["EXTENSION_FIELDS", "ModelConfig", "SHAPES", "ShapeSpec", "pad_to",
           "reference_fields", "shape_applicable"]


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention details ---
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric_ln
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 = full attention
    global_layers: tuple[int, ...] = ()  # full-attn layers despite window
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_d_ff: int = 0  # a routed expert's width (0 -> d_ff)
    n_shared_experts: int = 0  # SwiGLU of width n * moe_d_ff that every token takes
    first_dense_layers: int = 0  # leading layers with a dense MLP of width d_ff
    experts_held: int = 0  # the block of experts this chip holds (0 = all n_experts)
    norm_topk_prob: bool = True  # gates renormalized over the top-k (False: raw probs)
    router_loss: str = "switch"  # switch (+ 1e-3 z-loss) | seq_aux (per sequence, no z)

    # --- multi-head latent attention (DeepSeek-V2; kv_lora_rank 0 = none) ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- YaRN rope scaling (yarn_factor 0 = none) ---
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # --- SSM branch (hymba-style parallel heads) ---
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4
    d_ssm: int = 0  # inner width of the ssm branch (default d_model)

    # --- xLSTM ---
    xlstm: bool = False
    slstm_every: int = 0  # every k-th layer is sLSTM (0 = none)
    proj_factor: float = 2.0

    # --- structure / stubs ---
    arch_kind: str = "decoder"  # decoder | encdec
    n_enc_layers: int = 0
    enc_seq: int = 0  # stub audio frames (whisper: 1500)
    num_patches: int = 0  # stub vision patch tokens (vlm)

    # --- long-context applicability ---
    long_context_ok: bool = False

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def n_heads_padded(self, tp: int) -> int:
        return pad_to(self.n_heads, tp)

    def vocab_padded(self, tp: int) -> int:
        return pad_to(self.vocab_size, tp)

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def n_experts_held(self) -> int:
        return self.experts_held or self.n_experts

    @property
    def d_ssm_inner(self) -> int:
        return self.d_ssm or self.d_model

    def slstm_layers(self) -> tuple[int, ...]:
        if not (self.xlstm and self.slstm_every):
            return ()
        return tuple(
            i for i in range(self.n_layers) if i % self.slstm_every == self.slstm_every - 1
        )

    def window_for_layer(self, i: int) -> int:
        """Effective attention window for layer i (0 = full)."""
        if self.sliding_window and i not in self.global_layers:
            return self.sliding_window
        return 0

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla:
            r, rope, h = self.kv_lora_rank, self.qk_rope_head_dim, self.n_heads
            return (d * h * (self.qk_nope_head_dim + rope) + d * (r + rope) + r
                    + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                    + h * self.v_head_dim * d)
        return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d

    def _moe_params(self, experts: int) -> int:
        """A MoE layer's MLP with ``experts`` routed experts: the router
        (over all ``n_experts``), the experts, the shared experts."""
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        return (d * self.n_experts + experts * mlp_mult * d * self.expert_d_ff
                + self.n_shared_experts * mlp_mult * d * self.expert_d_ff)

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6 N D); a MoE
        layer counts the experts this chip holds (``experts_held``), and with
        latent attention (MLA) every norm scale is counted too, so that N is
        what :func:`~repro_torch.models.transformer.init_params` holds."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        hd = self.hd
        attn = self._attn_params()
        if self.mla:
            attn += 2 * d  # attn_norm, mlp_norm
            emb += d  # final_norm
        if self.xlstm:
            # mLSTM block: up(d->pf d) + gate(d->pf d) + qkv in pf*d space
            # + down(pf d->d).  Exact N is counted from init_params shapes at
            # dry-run time; this estimate only seeds reporting defaults.
            pf = self.proj_factor
            per_layer = int(3 * d * pf * d + 3 * (pf * d) * hd * self.n_heads)
        elif self.moe:
            mlp_mult = 3 if self.gated_mlp else 2
            dense = self.first_dense_layers
            return emb + self.n_layers * attn + dense * mlp_mult * d * self.d_ff + (
                self.n_layers - dense) * self._moe_params(self.n_experts_held)
        else:
            mlp_mult = 3 if self.gated_mlp else 2
            per_layer = attn + mlp_mult * d * self.d_ff
        if self.ssm:
            ds = self.d_ssm_inner
            per_layer += 2 * d * ds + ds * d + ds * self.ssm_conv + 2 * ds * self.ssm_state
        n_layers = self.n_layers + self.n_enc_layers
        if self.arch_kind == "encdec":
            per_layer += attn  # cross attention in decoder layers (approx)
        return emb + n_layers * per_layer

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k experts only, of all
        ``n_experts``; the shared experts and the router always)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        mlp_mult = 3 if self.gated_mlp else 2
        moe_layers = self.n_layers - self.first_dense_layers
        held = moe_layers * self.n_experts_held * mlp_mult * d * self.expert_d_ff
        active = moe_layers * self.top_k * mlp_mult * d * self.expert_d_ff
        return self.param_count() - held + active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason).  long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, "pure full-attention arch: long_500k skipped"
    return True, ""


# the fields the port adds to repro.configs.base.ModelConfig (module docstring)
EXTENSION_FIELDS = ("moe_d_ff", "n_shared_experts", "first_dense_layers", "experts_held",
                    "norm_topk_prob", "router_loss", "kv_lora_rank", "qk_nope_head_dim",
                    "qk_rope_head_dim", "v_head_dim", "yarn_factor", "yarn_original_max_pos",
                    "yarn_beta_fast", "yarn_beta_slow", "yarn_mscale", "yarn_mscale_all_dim")


def reference_fields(cfg: ModelConfig) -> dict:
    """``cfg`` as ``dataclasses.asdict`` of ``repro``'s ``ModelConfig`` gives
    it: every field but :data:`EXTENSION_FIELDS`, which must hold their
    defaults (the JAX package expresses no other value of them)."""
    set_ = [f.name for f in dataclasses.fields(cfg)
            if f.name in EXTENSION_FIELDS and getattr(cfg, f.name) != f.default]
    if set_:
        raise ValueError(f"{cfg.name} sets {set_}, which repro's ModelConfig does not have")
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in EXTENSION_FIELDS}
