"""Mistral-Large-Instruct-2407 (123B) — dense GQA decoder
[hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("mistral-large-123b")
def mistral_large_123b() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        source="[hf:mistralai/Mistral-Large-Instruct-2407]",
        n_layers=88,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        rope_theta=1.0e6,
        # 123B: one learner per pod (FSDP-16 x TP-16); the Hier-AVG hierarchy
        # lives on the pod axis — local = intra-pod, global = cross-pod DCI.
        layout=ParallelLayout(groups=1, local=1, fsdp=16, tp=16, microbatch=32),
    )
