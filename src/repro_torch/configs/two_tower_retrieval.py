"""two-tower-retrieval [RecSys'19 (YouTube); unverified]

embed_dim=256 tower_mlp=1024-512-256 interaction=dot, sampled-softmax
retrieval.  Item corpus 1M (retrieval_cand scores all of it).
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig(
    name="two-tower-retrieval",
    embed_dim=256, tower_dims=(1024, 512, 256),
    n_users=10_000_000, n_items=1_000_000,
    n_user_fields=4, n_item_fields=3, field_vocab=100_000,
    hist_len=20, feat_dim=64,
)

SMOKE = TwoTowerConfig(
    name="two-tower-smoke",
    embed_dim=16, tower_dims=(32, 16), n_users=1000, n_items=1000,
    n_user_fields=2, n_item_fields=2, field_vocab=50, hist_len=5, feat_dim=8,
)


@register("two-tower-retrieval")
def make() -> ArchSpec:
    return ArchSpec(
        name="two-tower-retrieval", family="recsys", config=CONFIG,
        smoke_config=SMOKE, shapes=RECSYS_SHAPES, source="RecSys'19 (YouTube)",
    )
