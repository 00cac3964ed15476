"""One construction path for executors (port of ``repro/serving/factory.py``).

    ex = make_executor("single", corpus, fused=True)          # on CUDA
    ex = make_executor("single", corpus, device="cpu")        # plain versions
    ex = make_executor("single", corpus, algorithm="text_first", fused=True,
                       budgets=replace(b, prune=True), layout="impact",
                       compress="int8")
    ex = make_executor("sharded", corpus, n_shards=8,
                       partitioner=RegionRangePartitioner(), routing="footprint")
    ex = make_executor("mesh", corpus, mesh=make_mesh((8, 1), ("data", "model")))
    # on every rank of an initialised process group of 8 (one per position)
    ex = make_executor("mesh", corpus, mesh=make_process_mesh((8, 1), ("data", "model")))

The corpus argument is duck-typed: anything with ``doc_terms``,
``doc_rects``, ``doc_amps``, ``pagerank`` and ``n_terms`` attributes
(:class:`repro_torch.corpus.SynthCorpus` in practice).
"""
from __future__ import annotations

from repro_torch.core import algorithms as alg
from repro_torch.core import ranking
from repro_torch.core.distributed import Partitioner
from repro_torch.core.engine import GeoSearchEngine
from repro_torch.device import resolve_device
from repro_torch.serving.executor import (
    MeshExecutor,
    ShardedExecutor,
    SingleDeviceExecutor,
    _check_routing,
)

EXECUTOR_KINDS = ("single", "sharded", "mesh")


def make_executor(
    kind: str,
    corpus,
    *,
    algorithm: str = "k_sweep",
    budgets: alg.QueryBudgets | None = None,
    weights: ranking.RankWeights | None = None,
    partitioner: Partitioner | None = None,
    routing: str = "broadcast",
    n_shards: int = 1,
    mesh=None,
    grid: int = 64,
    m_intervals: int = 2,
    fused: bool = False,
    use_pallas: bool = False,
    compress: "bool | str" = False,
    layout: str = "docid",
    device=None,
    telemetry=None,
):
    """Build an executor of ``kind`` over ``corpus`` on ``device`` (default
    CUDA; raises without it).

    * ``kind="single"``: one engine.  Partitioning and routing options do
      not apply and raise ``ValueError`` if set.
    * ``kind="sharded"``: host scatter-gather over ``n_shards`` per-shard
      engines, split by ``partitioner`` (default Morton).
    * ``kind="mesh"``: the serve step over ``mesh`` (required), on the
      mesh's device; the shard count comes from the mesh's doc axes.  A
      :func:`~repro_torch.core.distributed.make_mesh` mesh loops over the
      shards on one device; a
      :func:`~repro_torch.core.distributed.make_process_mesh` mesh has one
      process per position: call ``make_executor`` on every rank, run
      batches (a ``GeoServer``) on rank 0, ``serve_forever()`` on the
      others and ``close()`` on rank 0 at the end.

    ``algorithm`` is ``"k_sweep"``, ``"text_first"``, ``"geo_first"`` or
    ``"auto"`` (the cost-based planner picks one per query).  ``fused`` runs
    K-SWEEP through the fused sweep kernel (the pruned one under
    ``budgets.prune``) and pruned TEXT-FIRST through the text_probe kernel,
    under ``auto`` too; ``use_pallas`` scores toe prints on K-SWEEP's
    unfused path with the geo_score kernel (the reference's name for it;
    host executors only).  ``routing="footprint"`` (sharded/mesh) skips or
    masks shards no query footprint touches.  ``compress``
    (``"none"``/``"f16"``/``"int8"``) and ``layout`` (``"docid"``/
    ``"impact"``) select the index storage.  ``telemetry`` (a
    :class:`repro_torch.obs.Telemetry`) is attached before returning.
    """
    if kind not in EXECUTOR_KINDS:
        raise ValueError(f"kind must be one of {EXECUTOR_KINDS}, got {kind!r}")
    _check_routing(routing)
    if partitioner is not None and not isinstance(partitioner, Partitioner):
        raise TypeError(
            "partitioner must be a Partitioner instance; resolve strings at "
            "the CLI boundary with repro_torch.core.distributed.resolve_partitioner"
        )
    budgets = budgets or alg.QueryBudgets()
    kw = {}
    if use_pallas:
        if kind == "mesh":
            raise ValueError(
                "use_pallas applies to host executors only (the mesh step "
                "selects kernels via fused=)"
            )
        if algorithm == "k_sweep":
            from repro_torch.kernels.geo_score.ops import geo_score_toeprints

            kw["tp_scorer"] = geo_score_toeprints
    # the reference's rule: the kernels serve K-SWEEP (also under auto), and
    # TEXT-FIRST when pruned; the mesh step takes fused= itself
    if (
        fused
        and kind != "mesh"
        and (algorithm in ("k_sweep", "auto") or (algorithm == "text_first" and budgets.prune))
    ):
        kw["fused"] = True

    if kind == "single":
        if partitioner is not None or routing != "broadcast" or n_shards != 1:
            raise ValueError(
                "partitioner/routing/n_shards only apply to kind='sharded' "
                "or kind='mesh'"
            )
        eng = GeoSearchEngine.build(
            corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
            pagerank=corpus.pagerank, grid=grid, m_intervals=m_intervals,
            budgets=budgets, weights=weights, compress=compress, layout=layout,
            device=device,
        )
        executor = SingleDeviceExecutor(eng, algorithm, **kw)
    elif kind == "sharded":
        executor = ShardedExecutor.build(
            corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
            pagerank=corpus.pagerank, n_shards=n_shards, partitioner=partitioner,
            grid=grid, budgets=budgets, weights=weights, algorithm=algorithm,
            routing=routing, compress=compress, layout=layout, device=device, **kw,
        )
    else:  # mesh
        if mesh is None:
            raise ValueError("kind='mesh' requires mesh=")
        if device is not None and resolve_device(device) != mesh.device:
            raise ValueError(
                f"kind='mesh' runs on its mesh's device ({mesh.device}), not {device}: "
                "pass device= to make_mesh or make_process_mesh"
            )
        executor = MeshExecutor.build(
            corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
            pagerank=corpus.pagerank, mesh=mesh, partitioner=partitioner, grid=grid,
            budgets=budgets, weights=weights, algorithm=algorithm, fused=fused,
            routing=routing, compress=compress, layout=layout,
        )
    if telemetry is not None:
        executor.attach_telemetry(telemetry)
    return executor
