"""Hymba-1.5B — hybrid block with PARALLEL attention + Mamba(SSM) heads
[arXiv:2411.13676].

Hymba fuses attention heads and SSM heads inside the same layer (outputs are
normalized and averaged). Most layers use sliding-window attention; we model
that with a global ``sliding_window`` (the few full-attention layers of the
release are approximated by the window — noted in DESIGN.md). The SSM path is
a selective-scan (Mamba-style) head with state size 16.
"""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("hymba-1.5b")
def hymba_1_5b() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        source="[arXiv:2411.13676]",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_heads=25,
        ssm_expand=2,
        sliding_window=1024,
        layout=ParallelLayout(groups=4, local=4, fsdp=1, tp=16, microbatch=2),
    )
