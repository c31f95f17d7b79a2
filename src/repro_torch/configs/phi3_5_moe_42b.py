"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts, top-2 routing
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        source="[hf:microsoft/Phi-3.5-MoE-instruct]",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        expert_d_ff=6400,
        n_experts=16,
        top_k=2,
        vocab_size=32064,
        # 16 experts shard 1:1 over the TP-16 axis (expert parallelism).
        layout=ParallelLayout(groups=1, local=2, fsdp=8, tp=16, microbatch=16),
    )
