"""DeepSeek-67B — dense llama-arch GQA decoder [arXiv:2401.02954]."""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("deepseek-67b")
def deepseek_67b() -> ArchConfig:
    return ArchConfig(
        name="deepseek-67b",
        family="dense",
        source="[arXiv:2401.02954]",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab_size=102400,
        # One learner per pod (FSDP-16 x TP-16): hierarchy on the pod axis.
        layout=ParallelLayout(groups=1, local=1, fsdp=16, tp=16, microbatch=32),
    )
