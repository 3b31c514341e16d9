"""Architecture configuration schema for all assigned model families.

One ``ArchConfig`` describes any of the ten assigned architectures; family
behaviour is selected by `family` plus the optional sub-specs (MLA, MoE,
SSM, enc-dec, VLM).  Padding for tensor-parallel divisibility is *derived*
(`padded_*` properties) from the `tp` degree so the logical config stays
exactly the published one — padded heads/vocab/experts are mathematically
inert (zero-initialized, masked) and their FLOPs are charged as waste in
the roofline's MODEL_FLOPS/HLO_FLOPs ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MLASpec:
    """Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int             # per-expert FFN hidden dim
    n_dense_layers: int = 0   # leading dense (non-MoE) layers
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    shared_gate: bool = False  # Qwen2-MoE gates the shared expert


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "swiglu"       # swiglu | geglu | gelu (non-gated)
    rope_theta: float = 10_000.0
    rope_dim: Optional[int] = None     # partial rotary (None = full head_dim)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mla: Optional[MLASpec] = None
    moe: Optional[MoESpec] = None
    # SSM / hybrid
    ssm_state: int = 64       # Mamba2 N / RWKV head size
    ssm_expand: int = 2
    attn_every: int = 0       # Zamba2: shared attention block period
    # enc-dec (whisper): encoder frames are stub embeddings
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # vlm (paligemma): image patch prefix, stub embeddings
    n_prefix: int = 0
    # distribution degree this instance is padded for
    tp: int = 1
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # scan unrolling (dry-run cost-analysis instrumentation: the body of a
    # lax.scan is counted ONCE by XLA cost analysis; lowering at unroll=1
    # and unroll=2 and diffing isolates the per-layer body cost)
    scan_unroll: int = 1
    group_unroll: int = 1  # zamba2's outer (groups) scan
    # ---- beyond-paper performance variants (EXPERIMENTS.md §Perf) ----
    # cast fp32 master params to compute dtype ONCE per step instead of
    # per-layer inside the scan (cuts weight-read bytes ~2x in fwd+bwd)
    precast_params: bool = False
    # read MoE capacity buffers once for gate+up (stacked w_in einsum)
    fused_gate_up: bool = False
    # Ulysses-style sequence-parallel prefill (MLA archs): activations
    # sequence-sharded over `model`; attention head-parallel via all_to_all
    # on the low-rank latents; FFN TP with t_local-sized psums
    seq_parallel: bool = False
    # norms without f32 materialization of the residual stream (f32 only
    # in the reduction): cuts norm HBM traffic ~3x and keeps backward
    # cotangents bf16 (halving the activation-grad psums)
    fast_norms: bool = False
    # seq-parallel variant: replicate FFN weights so the FFN runs fully on
    # t_local rows with NO collectives (inference only; feasible when the
    # FFN is small, e.g. minicpm3's 6.1 GB bf16)
    replicate_ffn: bool = False

    # ------------------------------------------------------------------ #
    # derived dims
    # ------------------------------------------------------------------ #

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        return _round_up(self.n_heads, self.tp)

    @property
    def padded_kv_heads(self) -> int:
        """MHA (kv == q heads): KV pads with Q so the group stays 1 and
        head-parallel sharding divides.  GQA (kv < q): KV stays unpadded —
        sharded when divisible, replicated otherwise (the padded q-head
        group mapping still divides because padded_heads % kv == 0)."""
        if self.n_kv_heads == self.n_heads:
            return self.padded_heads
        return self.n_kv_heads

    @property
    def kv_sharded(self) -> bool:
        return self.padded_kv_heads % self.tp == 0

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.tp * 128)

    @property
    def padded_experts(self) -> int:
        assert self.moe is not None
        return _round_up(self.moe.n_routed, self.tp)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_state

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.ssm_state

    @property
    def padded_rwkv_heads(self) -> int:
        return _round_up(self.rwkv_heads, self.tp)

    @property
    def padded_ssm_heads(self) -> int:
        return _round_up(self.ssm_heads, self.tp)

    def with_tp(self, tp: int) -> "ArchConfig":
        return dataclasses.replace(self, tp=tp)

    # ------------------------------------------------------------------ #
    # parameter count (logical, for 6ND roofline MODEL_FLOPS)
    # ------------------------------------------------------------------ #

    def param_count(self, active_only: bool = False) -> int:
        """Approximate logical parameter count; `active_only` counts only
        routed experts actually selected per token (MoE 6*N_active*D)."""
        d, dh = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "rwkv":
            # time-mix: r,k,v,g,w,o (d x d) + lora mixers (small) + channel mix
            per_layer = 6 * d * d + 2 * d * self.d_ff + d * self.d_ff
        elif self.family == "hybrid":
            din = self.d_inner
            n = self.ssm_state
            mamba = d * 2 * din + din * d + self.ssm_heads * (2 * n) * 0  # in/out proj
            mamba += 2 * din * n  # B,C projections
            per_layer = mamba
            # shared attention block amortized over its invocations
            shared = 4 * d * d + 3 * d * self.d_ff
            n_invocations = max(1, self.n_layers // max(1, self.attn_every))
            emb += shared  # counted once (shared params)
        else:
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d
            if self.mla is not None:
                m = self.mla
                attn = (
                    d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            if self.moe is not None:
                k = self.moe.top_k if active_only else self.moe.n_routed
                gated = 3 if self.act in ("swiglu", "geglu") else 2
                ffn = (k + self.moe.n_shared * 2) * gated * d * self.moe.d_expert
            else:
                gated = 3 if self.act in ("swiglu", "geglu") else 2
                ffn = gated * d * self.d_ff
            per_layer = attn + ffn
        total = emb + self.n_layers * per_layer
        if self.family == "encdec":
            total += self.n_enc_layers * per_layer
        return total

    # ------------------------------------------------------------------ #
    # reduced config for CPU smoke tests
    # ------------------------------------------------------------------ #

    def reduced(self) -> "ArchConfig":
        kw = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            ssm_state=16,
            enc_seq=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_prefix=min(self.n_prefix, 8),
            tp=1,
        )
        if self.mla is not None:
            kw["mla"] = MLASpec(
                q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16
            )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_routed=8, n_shared=min(self.moe.n_shared, 2), top_k=2, d_expert=32,
                n_dense_layers=min(self.moe.n_dense_layers, 1),
            )
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 4
        return dataclasses.replace(self, **kw)
