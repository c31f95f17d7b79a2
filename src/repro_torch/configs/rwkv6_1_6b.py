"""RWKV-6 "Finch" 1.6B — attention-free RNN with data-dependent decay
[arXiv:2404.05892].

Sequence mixing is the WKV6 recurrence (O(1) state per head), so decode —
including long_500k — carries a constant-size state instead of a KV cache.
The WKV recurrence is implemented as a chunked Pallas kernel
(kernels/rwkv6_wkv.py) with a pure-jnp oracle.
"""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("rwkv6-1.6b")
def rwkv6_1_6b() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="[arXiv:2404.05892]",
        n_layers=24,
        d_model=2048,
        n_heads=0,              # attention-free
        n_kv_heads=0,
        head_dim=64,            # WKV head size
        ssm_heads=32,           # 2048 / 64
        ssm_state=64,           # per-head state is head_dim x head_dim
        d_ff=7168,
        vocab_size=65536,
        layout=ParallelLayout(groups=4, local=4, fsdp=1, tp=16, microbatch=2),
    )
