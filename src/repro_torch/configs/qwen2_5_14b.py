"""qwen2.5-14b [hf:Qwen/Qwen2.5-14B; hf]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064, QKV bias (dense).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2.5-14b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen2.5-smoke",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_ff=192, vocab=512,
    qkv_bias=True, attn_chunk=16,
)


@register("qwen2.5-14b")
def make() -> ArchSpec:
    return ArchSpec(
        name="qwen2.5-14b", family="lm", config=CONFIG, smoke_config=SMOKE,
        shapes=lm_shapes(full_attention=True, decode_batch=128),
        source="hf:Qwen/Qwen2.5-14B",
    )
