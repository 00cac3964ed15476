"""bst — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874; paper]

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys import BSTConfig

CONFIG = BSTConfig(
    name="bst",
    embed_dim=32, seq_len=20, n_blocks=1, n_heads=8, mlp_dims=(1024, 512, 256),
    n_items=10_000_000, n_other_fields=4, field_vocab=1_000_000,
)

SMOKE = BSTConfig(
    name="bst-smoke",
    embed_dim=16, seq_len=5, n_blocks=1, n_heads=2, mlp_dims=(32, 16),
    n_items=500, n_other_fields=2, field_vocab=50,
)


@register("bst")
def make() -> ArchSpec:
    return ArchSpec(
        name="bst", family="recsys", config=CONFIG, smoke_config=SMOKE,
        shapes=RECSYS_SHAPES, source="arXiv:1905.06874",
    )
