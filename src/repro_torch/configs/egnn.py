"""egnn [arXiv:2102.09844; paper]

n_layers=4 d_hidden=64 equivariance=E(n).  Shape set: full_graph_sm (Cora),
minibatch_lg (Reddit-scale sampled), ogb_products (full-batch 2.4M nodes),
molecule (batched small graphs).
"""
import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec, register
from repro_torch.models.egnn import EGNNConfig

# bf16 message compute, f32 parameters and loss (the reference's CONFIG)
CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_feat=1433, n_classes=7,
                    compute_dtype=torch.bfloat16)

SMOKE = EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_feat=8, n_classes=4)

SHAPES = (
    ShapeSpec("full_graph_sm", "gnn_full",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeSpec("minibatch_lg", "gnn_minibatch",
              dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
                   fanouts=(15, 10), d_feat=602, n_classes=41)),
    ShapeSpec("ogb_products", "gnn_full",
              dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_classes=47)),
    ShapeSpec("molecule", "gnn_molecule",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=11)),
)


@register("egnn")
def make() -> ArchSpec:
    return ArchSpec(
        name="egnn", family="gnn", config=CONFIG, smoke_config=SMOKE,
        shapes=SHAPES, source="arXiv:2102.09844",
    )
