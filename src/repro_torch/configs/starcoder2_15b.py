"""StarCoder2-15B — GQA + RoPE code model, sliding-window attention 4096
[arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("starcoder2-15b")
def starcoder2_15b() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b",
        family="dense",
        source="[arXiv:2402.19173]",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        sliding_window=4096,
        act="gelu",
        layout=ParallelLayout(groups=2, local=2, fsdp=4, tp=16, microbatch=8),
    )
