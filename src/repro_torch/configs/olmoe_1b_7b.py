"""olmoe-1b-7b [arXiv:2409.02060; hf]

16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, n_experts=64, top_k=8, qk_norm=True,
)

SMOKE = TransformerConfig(
    name="olmoe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
    vocab=512, n_experts=8, top_k=2, qk_norm=True, attn_chunk=16,
)


@register("olmoe-1b-7b")
def make() -> ArchSpec:
    return ArchSpec(
        name="olmoe-1b-7b", family="lm", config=CONFIG, smoke_config=SMOKE,
        shapes=lm_shapes(full_attention=True), source="arXiv:2409.02060",
    )
