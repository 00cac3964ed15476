"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf]

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias (dense).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen1.5-0.5b",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen1.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    qkv_bias=True, attn_chunk=16,
)


@register("qwen1.5-0.5b")
def make() -> ArchSpec:
    return ArchSpec(
        name="qwen1.5-0.5b", family="lm", config=CONFIG, smoke_config=SMOKE,
        shapes=lm_shapes(full_attention=True), source="hf:Qwen/Qwen1.5-0.5B",
    )
