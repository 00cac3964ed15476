"""dcn-v2 [arXiv:2008.13535; paper]

n_dense=13 n_sparse=26 embed_dim=16 n_cross_layers=3 mlp=1024-1024-512,
cross interaction; Criteo-scale per-field vocabularies.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.data.recsys import CRITEO_VOCABS
from repro_torch.models.recsys import DCNv2Config

CONFIG = DCNv2Config(
    name="dcn-v2",
    n_dense=13, n_sparse=26, embed_dim=16, n_cross_layers=3,
    mlp_dims=(1024, 1024, 512), vocab_sizes=CRITEO_VOCABS,
)

SMOKE = DCNv2Config(
    name="dcn-v2-smoke",
    n_dense=4, n_sparse=6, embed_dim=8, n_cross_layers=2, mlp_dims=(32, 16),
    vocab_sizes=(50, 100, 200, 50, 30, 70),
)


@register("dcn-v2")
def make() -> ArchSpec:
    return ArchSpec(
        name="dcn-v2", family="recsys", config=CONFIG, smoke_config=SMOKE,
        shapes=RECSYS_SHAPES, source="arXiv:2008.13535",
    )
