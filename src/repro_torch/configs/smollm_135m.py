"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 (llama-arch small, dense).
"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536, vocab=49152,
    tie_embeddings=True,
)

SMOKE = TransformerConfig(
    name="smollm-smoke",
    n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, d_ff=96, vocab=512,
    attn_chunk=16,
)


@register("smollm-135m")
def make() -> ArchSpec:
    return ArchSpec(
        name="smollm-135m", family="lm", config=CONFIG, smoke_config=SMOKE,
        shapes=lm_shapes(full_attention=True), source="hf:HuggingFaceTB/SmolLM-135M",
    )
