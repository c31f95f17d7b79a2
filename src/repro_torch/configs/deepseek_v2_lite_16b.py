"""DeepSeek-V2-Lite (16B total / 2.4B active) — MLA attention
(kv_lora_rank=512) + fine-grained MoE: 2 shared + 64 routed experts, top-6,
first layer dense [arXiv:2405.04434].

Note on the pool spec: the assignment line reads "MoE 64e top-6 ... 2
shared+160 routed". 160 routed contradicts 64e and the source paper's Lite
configuration (64 routed + 2 shared, top-6); we follow the source paper /
model card. d_ff=1408 is the per-expert (and shared-expert) width; the single
leading dense layer uses the release's 10944 FFN width.
"""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("deepseek-v2-lite-16b")
def deepseek_v2_lite() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        source="[arXiv:2405.04434]",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,           # MLA: per-head latent decompression
        d_ff=10944,              # dense first layer
        expert_d_ff=1408,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        first_k_dense=1,
        vocab_size=102400,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        layout=ParallelLayout(groups=2, local=2, fsdp=4, tp=16, microbatch=4),
    )
