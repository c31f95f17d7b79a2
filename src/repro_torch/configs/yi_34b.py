"""Yi-34B — dense llama-arch GQA decoder [arXiv:2403.04652]."""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("yi-34b")
def yi_34b() -> ArchConfig:
    return ArchConfig(
        name="yi-34b",
        family="dense",
        source="[arXiv:2403.04652]",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5.0e6,
        # 34B bf16 params need >= 8-way FSDP on 16GB HBM alongside TP-16:
        # 2 learners/pod, one local cluster of S=2 per pod.
        layout=ParallelLayout(groups=1, local=2, fsdp=8, tp=16, microbatch=16),
    )
