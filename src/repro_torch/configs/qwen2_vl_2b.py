"""Qwen2-VL-2B — VLM language backbone with M-RoPE (multimodal rotary
position embedding over (temporal, height, width) sections) and dynamic
resolution [arXiv:2409.12191].

The ViT vision encoder + projector is STUBBED per assignment: ``input_specs``
supplies patch embeddings [B, n_patches, d_model] plus the (t, h, w) position
grid that M-RoPE consumes; the 28-layer LM is fully implemented.
"""
from repro_torch.configs.base import ArchConfig, ParallelLayout, register


@register("qwen2-vl-2b")
def qwen2_vl_2b() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        source="[arXiv:2409.12191]",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        rope_theta=1.0e6,
        mrope=True,
        mrope_sections=(16, 24, 24),   # t/h/w split of the 64 rotary pairs
        frontend="vision_patches",
        frontend_tokens=256,           # stub: one image -> 256 patch embeddings
        tie_embeddings=True,
        layout=ParallelLayout(groups=4, local=4, fsdp=1, tp=16, microbatch=2),
    )
