"""autoint [arXiv:1810.11921; paper]

n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2 d_attn=32 (self-attn
feature interaction), Avazu-style mixed vocabularies.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.data.recsys import avazu_like_vocabs
from repro_torch.models.recsys import AutoIntConfig

CONFIG = AutoIntConfig(
    name="autoint",
    n_sparse=39, embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32,
    vocab_sizes=avazu_like_vocabs(39),
)

SMOKE = AutoIntConfig(
    name="autoint-smoke",
    n_sparse=5, embed_dim=8, n_attn_layers=2, n_heads=2, d_attn=8,
    vocab_sizes=(50, 100, 200, 50, 30),
)


@register("autoint")
def make() -> ArchSpec:
    return ArchSpec(
        name="autoint", family="recsys", config=CONFIG, smoke_config=SMOKE,
        shapes=RECSYS_SHAPES, source="arXiv:1810.11921",
    )
