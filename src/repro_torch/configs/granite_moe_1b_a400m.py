"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-moe-1b-a400m",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, n_experts=32, top_k=8, rope_theta=10000.0,
)

SMOKE = TransformerConfig(
    name="granite-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab=512, n_experts=4, top_k=2, attn_chunk=16,
)


@register("granite-moe-1b-a400m")
def make() -> ArchSpec:
    return ArchSpec(
        name="granite-moe-1b-a400m", family="lm", config=CONFIG, smoke_config=SMOKE,
        shapes=lm_shapes(full_attention=True),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
