"""The paper's geographic query processing, ported to PyTorch.

Modules (each the counterpart of ``repro/core/<name>.py``):
  geometry       rectangles, Morton codes, tile math
  footprint      amplitude-weighted rect-set footprints + geo scores
  text_index     CSR inverted index + impacts; PForDelta store, impact layout
  spatial_index  Morton toe-print store + tile-interval grid
  ranking        combined text/geo/pagerank ranking
  algorithms     TEXT-FIRST, GEO-FIRST, K-SWEEP (batched) + exact oracle
  planner        QueryPlan, cost model and the per-query Planner
  engine         GeoSearchEngine facade
  distributed    partitioners, coverage routing, ShardedGeoIndex, the meshes and their step
  collectives    psum, pmax, all_gather, psum_scatter, all_to_all, replicated over mesh
                 axes (port only)
  convert        the reference's index arrays → the port's GeoIndex
"""
from repro_torch.core.algorithms import (
    ALGORITHMS,
    QueryBatch,
    QueryBudgets,
    TopKResult,
    get_algorithm,
    register_algorithm,
)
from repro_torch.core.distributed import (
    COVERAGE_GRID,
    HashPartitioner,
    Mesh,
    MortonPartitioner,
    Partitioner,
    ProcessMesh,
    RegionRangePartitioner,
    ShardedGeoIndex,
    make_mesh,
    make_process_mesh,
    make_serve_fn,
    resolve_partitioner,
    shard_corpus_np,
    shard_rows,
)
from repro_torch.core.engine import GeoIndex, GeoSearchEngine
from repro_torch.core.planner import COST_KEYS, CostModel, Planner, QueryFeatures, QueryPlan
from repro_torch.core.ranking import RankWeights

__all__ = [
    "GeoIndex", "GeoSearchEngine", "QueryBatch", "QueryBudgets",
    "TopKResult", "ALGORITHMS", "get_algorithm", "register_algorithm",
    "QueryPlan", "RankWeights", "COST_KEYS", "CostModel", "Planner", "QueryFeatures",
    "COVERAGE_GRID", "Partitioner", "HashPartitioner", "MortonPartitioner",
    "RegionRangePartitioner", "resolve_partitioner", "ShardedGeoIndex", "shard_corpus_np",
    "shard_rows", "Mesh", "ProcessMesh", "make_mesh", "make_process_mesh", "make_serve_fn",
]
