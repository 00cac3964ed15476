"""One construction path for executors (port of ``repro/serving/factory.py``).

    ex = make_executor("single", corpus, fused=True)          # on CUDA
    ex = make_executor("single", corpus, device="cpu")        # plain versions
    ex = make_executor("single", corpus, algorithm="text_first", fused=True,
                       budgets=replace(b, prune=True), layout="impact",
                       compress="int8")

The corpus argument is duck-typed: anything with ``doc_terms``,
``doc_rects``, ``doc_amps``, ``pagerank`` and ``n_terms`` attributes
(:class:`repro_torch.corpus.SynthCorpus` in practice).
"""
from __future__ import annotations

from repro_torch.core import algorithms as alg
from repro_torch.core import ranking
from repro_torch.core.engine import GeoSearchEngine
from repro_torch.serving.executor import SingleDeviceExecutor, reject_telemetry

EXECUTOR_KINDS = ("single", "sharded", "mesh")


def make_executor(
    kind: str,
    corpus,
    *,
    algorithm: str = "k_sweep",
    budgets: alg.QueryBudgets | None = None,
    weights: ranking.RankWeights | None = None,
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

    ``algorithm`` is ``"k_sweep"``, ``"text_first"``, ``"geo_first"`` or
    ``"auto"`` (the cost-based planner picks one per query).  ``fused`` runs
    K-SWEEP through the fused sweep kernel (the pruned one under
    ``budgets.prune``) and pruned TEXT-FIRST through the text_probe kernel,
    under ``auto`` too; ``use_pallas`` scores toe prints on K-SWEEP's unfused path with
    the geo_score kernel (the reference's name for it).  ``compress``
    (``"none"``/``"f16"``/``"int8"``) and ``layout`` (``"docid"``/
    ``"impact"``) select the index storage.  ``telemetry`` must be ``None``
    until the obs slice lands.
    """
    if kind not in EXECUTOR_KINDS:
        raise ValueError(f"kind must be one of {EXECUTOR_KINDS}, got {kind!r}")
    if kind != "single":
        raise NotImplementedError(
            f"kind={kind!r} is not ported yet: the sharded and mesh executors "
            "arrive with the distributed slice"
        )
    reject_telemetry(telemetry)
    budgets = budgets or alg.QueryBudgets()
    kw = {}
    if use_pallas and algorithm == "k_sweep":
        from repro_torch.kernels.geo_score.ops import geo_score_toeprints

        kw["tp_scorer"] = geo_score_toeprints
    # the reference's rule: the kernels serve K-SWEEP (also under auto), and
    # TEXT-FIRST when pruned
    if fused and (
        algorithm in ("k_sweep", "auto") or (algorithm == "text_first" and budgets.prune)
    ):
        kw["fused"] = True
    eng = GeoSearchEngine.build(
        corpus.doc_terms, corpus.doc_rects, corpus.doc_amps, corpus.n_terms,
        pagerank=corpus.pagerank, grid=grid, m_intervals=m_intervals,
        budgets=budgets, weights=weights, compress=compress, layout=layout,
        device=device,
    )
    return SingleDeviceExecutor(eng, algorithm, **kw)
