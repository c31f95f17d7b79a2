"""Configuration system for the Hier-AVG framework.

Every assigned architecture is an :class:`ArchConfig` registered under its
pool id (``--arch <id>``).  Configs are plain frozen dataclasses so they are
hashable and trivially serializable.  A copy of ``repro/configs/base.py``:
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

# the one definition of the default bucket cap (no circular import: comm/
# never imports configs/)
from repro_torch.comm.bucket import DEFAULT_BUCKET_BYTES


@dataclass(frozen=True)
class ParallelLayout:
    """How one pod's 16-way data axis is factored for this architecture.

    ``groups * local * fsdp`` must equal the data-axis size of the pod mesh
    (16 on the production v5e pod).  ``local`` is the paper's ``S`` (learners
    per local-averaging cluster), ``groups`` the number of clusters per pod,
    and ``fsdp`` the ZeRO-style shard factor *inside* one learner.
    """

    groups: int = 4
    local: int = 4
    fsdp: int = 1
    tp: int = 16
    microbatch: int = 1   # gradient-accumulation splits per SGD step

    @property
    def data_ways(self) -> int:
        return self.groups * self.local * self.fsdp

    @property
    def learners_per_pod(self) -> int:
        return self.groups * self.local

    @property
    def chips_per_pod(self) -> int:
        return self.data_ways * self.tp

    def validate(self, chips_per_pod: int = 256) -> None:
        """Any G*S*F*TP factorization of the pod is a valid layout (the
        production pod is 256 chips; the spec's (16, 16) data x model view
        is the TP=16 slice of this family)."""
        if self.chips_per_pod != chips_per_pod:
            raise ValueError(
                f"layout {self} uses {self.chips_per_pod} chips/pod, "
                f"expected {chips_per_pod}"
            )


@dataclass(frozen=True)
class HierAvgParams:
    """The paper's algorithm knobs (Algorithm 1), generalized to an N-level
    reduction hierarchy.

    ``plan`` is a ReductionPlan spec string (core/plan.py), e.g.
    ``"local@4:cast:bfloat16/pod@8/global@16:topk:0.05"``.  When set it
    wins over ``k1``/``k2``/``reducer`` (which are back-filled from the
    plan: ``k1`` = innermost period, ``k2`` = outermost); when unset, the
    legacy ``(k1, k2, reducer)`` trio builds the paper's 2-level plan
    bit-identically.

    ``bucket_bytes`` caps the flat-buffer buckets compressed reducers pack
    the pytree into before reducing (comm/bucket.py): compressed levels
    run one grouped collective per bucket instead of per leaf, and sparse
    reducers pick k globally per bucket.  ``0`` disables auto-bucketing
    (reducers marked ``:bucketed`` in the spec still pack); the dense
    ``mean`` is never auto-bucketed, so the default path is unchanged.

    ``overlap`` picks the bucket *schedule*: on (default), bucketed
    levels run the pipelined engine (comm/bucket.py Pipelined), which
    issues bucket *i*'s grouped mean before bucket *i+1*'s compress; off
    pins the strictly serial compress-then-reduce schedule.  Per-level
    ``:pipelined`` / ``:serial`` spec modifiers override the knob.
    Single-bucket layouts are identical either way.
    """

    k1: int = 4          # innermost (local) averaging interval (SGD steps)
    k2: int = 8          # outermost (global) averaging interval
    # S (cluster size) comes from ParallelLayout.local / topology, and P from
    # the topology's total learner count.
    reducer: str = "mean"  # reduction payload spec, e.g. "topk:0.1" (comm/)
    plan: Optional[str] = None  # N-level plan spec; wins over k1/k2/reducer
    bucket_bytes: int = DEFAULT_BUCKET_BYTES
    overlap: bool = True  # pipelined (overlapped) bucket schedule

    def __post_init__(self):
        if self.bucket_bytes < 0:
            raise ValueError(
                f"bucket_bytes must be >= 0, got {self.bucket_bytes}")
        if self.plan is not None:
            # lazy import: core.plan owns parsing; this validates level
            # names, reducer specs, and period/axes nesting at build time
            from repro_torch.core.plan import ReductionPlan
            p = ReductionPlan.parse(self.plan)
            # back-fill the legacy knobs so k1/k2-reading code stays
            # meaningful
            object.__setattr__(self, "k1", p.levels[0].period)
            object.__setattr__(self, "k2", p.total_period)
            return
        if self.k1 < 1 or self.k2 < self.k1:
            raise ValueError(f"need 1 <= K1 <= K2, got K1={self.k1} K2={self.k2}")
        if self.k2 % self.k1 != 0:
            raise ValueError(f"K2 ({self.k2}) must be a multiple of K1 ({self.k1})")
        # lazy import: comm owns spec parsing; resolving (and discarding)
        # the reducer validates family AND arguments at config-build time
        from repro_torch.comm import get_reducer
        get_reducer(self.reducer)

    @property
    def beta(self) -> int:
        return self.k2 // self.k1

    @property
    def resolved_plan(self):
        """The ReductionPlan this config describes (parsed fresh), through
        ``bucket_bytes`` bucketing — identical to what
        ``resolve_plan(self)`` gives the round builders, so comm state
        initialized from it always matches."""
        from repro_torch.core.plan import ReductionPlan, apply_bucketing
        if self.plan is not None:
            p = ReductionPlan.parse(self.plan)
        else:
            p = ReductionPlan.from_k1_k2(self.k1, self.k2, self.reducer)
        return apply_bucketing(p, self.bucket_bytes, self.overlap)

    @property
    def batch_dims(self) -> Tuple[int, ...]:
        """Leading round-batch dims (outermost ratio first); the 2-level
        plan gives the familiar (beta, k1)."""
        return self.resolved_plan.batch_dims

    @property
    def steps_per_round(self) -> int:
        """SGD steps per round == the outermost period (== k2)."""
        return self.k2


@dataclass(frozen=True)
class ArchConfig:
    """A model architecture from the assigned pool.

    The union of fields across all six families (dense / moe / ssm / hybrid /
    vlm / audio); unused fields stay at their zero defaults.
    """

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                      # citation ([arXiv:...] / [hf:...])

    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0                 # 0 => attention-free (rwkv)
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                # 0 => d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0             # per-expert FFN width (0 => d_ff)
    first_k_dense: int = 0           # leading dense layers before MoE stack
    router_aux_coef: float = 0.01    # load-balance loss weight
    capacity_factor: float = 1.25    # expert capacity slack (>=E/top_k: dropless)

    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0            # 0 => standard GQA
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM / hybrid ---
    ssm_state: int = 0               # SSM state size (mamba); rwkv head-state
    ssm_heads: int = 0               # parallel SSM heads (hymba) / rwkv heads
    ssm_expand: int = 1

    # --- encoder-decoder / multimodal ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: str = ""               # "" | "audio_frames" | "vision_patches"
    frontend_tokens: int = 0         # stub frontend sequence length (train shapes)

    # --- attention details ---
    sliding_window: int = 0          # 0 => full causal; >0 => SWA window
    long_context_window: int = 8192  # rolling-buffer window used for long_500k
    rope_theta: float = 1.0e4
    mrope: bool = False              # Qwen2-VL multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    norm_eps: float = 1.0e-5
    tie_embeddings: bool = False
    act: str = "silu"

    layout: ParallelLayout = field(default_factory=ParallelLayout)

    # ------------------------------------------------------------------ #

    def __post_init__(self):
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"{self.name}: n_heads {self.n_heads} not divisible by "
                f"n_kv_heads {self.n_kv_heads}"
            )

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 so the vocab dim always
        shards over TP-16 (embedding/lm_head allocation size; labels stay
        within the true vocab)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch has a native sub-quadratic sequence mixer."""
        return self.family in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic (approximate) parameter count for roofline MODEL_FLOPS."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        n = 0
        # embeddings (+ output head unless tied)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":  # rwkv6
            per_layer += 4 * d * d          # r,k,v,g time-mix projections
            per_layer += d * d              # output
            per_layer += int(1.5 * d * self.d_ff)  # channel mix (k,v, r gate)
        else:
            if self.n_heads:
                q = self.n_heads * hd
                if self.kv_lora_rank:  # MLA
                    per_layer += d * self.kv_lora_rank
                    per_layer += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.v_head_dim)
                    per_layer += d * self.n_heads * (
                        self.qk_nope_head_dim + self.qk_rope_head_dim)
                    per_layer += self.n_heads * self.v_head_dim * d
                else:
                    kv = self.n_kv_heads * hd
                    per_layer += d * (q + 2 * kv) + q * d
            if self.family == "hybrid":
                # parallel SSM heads alongside attention
                per_layer += 2 * d * d * self.ssm_expand
            mats = 3 if self.act == "silu" else 2  # swiglu vs gelu/relu MLP
            if self.uses_moe:
                eff = self.expert_d_ff or self.d_ff
                per_layer += mats * d * eff * (self.n_experts + self.n_shared_experts)
                per_layer += d * self.n_experts  # router
            else:
                per_layer += mats * d * self.d_ff
        n += per_layer * L
        if self.is_encoder_decoder:
            # encoder layers: self-attn + ffn; decoder already counted above,
            # add cross-attention for decoder layers
            enc = self.n_encoder_layers
            q = self.n_heads * hd
            kv = self.n_kv_heads * hd
            mats = 3 if self.act == "silu" else 2
            n += enc * (d * (q + 2 * kv) + q * d + mats * d * self.d_ff)
            n += L * (d * (q + 2 * kv) + q * d)  # cross attn
        return n

    def active_param_count(self) -> int:
        """Params touched per token (== param_count unless MoE)."""
        if not self.uses_moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        eff = self.expert_d_ff or self.d_ff
        mats = 3 if self.act == "silu" else 2
        total = self.param_count()
        all_experts = mats * d * eff * self.n_experts * (L - self.first_k_dense)
        active = mats * d * eff * self.top_k * (L - self.first_k_dense)
        return total - all_experts + active

    # ------------------------------------------------------------------ #

    def reduced(self) -> "ArchConfig":
        """A smoke-test variant of the same family: 2 layers, d_model<=512,
        <=4 experts — runs a real forward/train step on one CPU device."""
        d = min(self.d_model, 256)
        n_heads = 0
        n_kv = 0
        hd = 0
        if self.n_heads:
            n_heads = min(self.n_heads, 4)
            n_kv = max(1, min(self.n_kv_heads, n_heads))
            while n_heads % n_kv:
                n_kv -= 1
            hd = 32
        changes = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            layout=ParallelLayout(1, 1, 1, 1),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=128,
        )
        if self.uses_moe:
            changes.update(
                n_experts=min(self.n_experts, 4),
                n_shared_experts=min(self.n_shared_experts, 1),
                top_k=min(self.top_k, 2),
                expert_d_ff=min(self.expert_d_ff or self.d_ff, 128),
                first_k_dense=min(self.first_k_dense, 1),
            )
        if self.kv_lora_rank:
            changes.update(
                kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                v_head_dim=32, head_dim=0,
            )
        if self.ssm_state:
            changes.update(ssm_state=min(self.ssm_state, 8),
                           ssm_heads=min(self.ssm_heads, 4) or 4)
        if self.family == "ssm":
            changes.update(ssm_heads=4, head_dim=d // 4)
        if self.is_encoder_decoder:
            changes.update(n_encoder_layers=2)
        if self.frontend:
            changes.update(frontend_tokens=min(self.frontend_tokens, 16) or 16)
        if self.mrope:
            d2 = (changes.get("head_dim") or hd) // 2
            s1 = d2 // 4
            s2 = (d2 - s1) // 2
            changes.update(mrope_sections=(s1, s2, d2 - s1 - s2))
        return dataclasses.replace(self, **changes)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------- #
# Input shapes (assigned)
# ---------------------------------------------------------------------- #

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------- #
# Registry
# ---------------------------------------------------------------------- #

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    # import arch modules lazily so the registry is populated
    from repro_torch import configs as _pkg  # noqa: F401  (triggers submodule imports)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    return cfg


def list_archs():
    from repro_torch import configs as _pkg  # noqa: F401
    return sorted(_REGISTRY)
