"""geoweb — the paper's own system at production scale (port of
``repro/configs/geoweb.py``).

64M-document web corpus (national-domain crawl scale, paper §III) sharded
over the mesh's doc axes; three serve cells, one per paper algorithm
(§IV A/B/C).  ``CONFIG`` is guarded by ``launch/steps.py``'s int32 check
(it needs at least 8 doc shards); ``SMOKE`` runs with real tensors on one
card.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchSpec, ShapeSpec, register
from repro_torch.core.algorithms import QueryBudgets
from repro_torch.core.ranking import RankWeights


@dataclass(frozen=True)
class GeoWebConfig:
    name: str = "geoweb"
    n_docs: int = 67_108_864  # 2^26 (global)
    n_terms: int = 1_048_576
    avg_postings_per_doc: int = 128
    max_rects: int = 2  # toe prints per doc (avg; doc-major mirror uses R=4)
    doc_major_rects: int = 4
    grid: int = 1024  # the paper's 1024x1024 tile domain
    m_intervals: int = 2
    query_batch: int = 4096  # global queries per serve step
    d_terms: int = 4
    q_rects: int = 2
    budgets: QueryBudgets = QueryBudgets(
        max_candidates=4096, max_tiles=256, k_sweeps=8, sweep_budget=16384,
        top_k=10, early_termination=True,
    )
    weights: RankWeights = RankWeights()
    # lossy-compressed (f16) footprint + impact data — the paper's own
    # future-work proposal
    compress: bool = True


CONFIG = GeoWebConfig()

SMOKE = GeoWebConfig(
    name="geoweb-smoke",
    n_docs=512, n_terms=128, avg_postings_per_doc=16, grid=32,
    query_batch=8,
    budgets=QueryBudgets(
        max_candidates=256, max_tiles=64, k_sweeps=4, sweep_budget=256, top_k=10
    ),
)

SHAPES = (
    ShapeSpec("serve_ksweep", "geo_serve", dict(algorithm="k_sweep")),
    ShapeSpec("serve_textfirst", "geo_serve", dict(algorithm="text_first")),
    ShapeSpec("serve_geofirst", "geo_serve", dict(algorithm="geo_first")),
)


@register("geoweb")
def make() -> ArchSpec:
    return ArchSpec(
        name="geoweb", family="geoweb", config=CONFIG, smoke_config=SMOKE,
        shapes=SHAPES, source="the paper (CS.IR 2010)",
    )
