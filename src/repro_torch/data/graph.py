"""Graph data (port of ``repro/data/graph.py``): synthetic power-law
graphs, a fanout neighbour sampler (GraphSAGE-style) and batches of small
molecules.

The reference draws with numpy's ``default_rng``, so the port gives the
same arrays bit for bit under the same numpy: the graph (:class:`CSRGraph`)
stays on the host as numpy, as the sampler's input pipeline reads it, and
the batches are tensors on ``device`` (CUDA unless given) with the
reference's dtypes: f32 features and coordinates, i32 ids, a ``bool``
``edge_mask``, i32 labels (−1 on padding rows).

:func:`make_powerlaw_graph` runs its two slow steps on ``device``: the
hub-biased endpoint draw (``Generator.choice(n, size, p=w)`` is
``cdf.searchsorted(rng.random(size), side="right")``; the port takes the
same ``rng.random`` draws, so the stream that follows is unchanged, and
searches the f64 cdf with ``torch.searchsorted``) and the stable sort by
source (``torch.sort(stable=True)``).  At ``minibatch_lg``'s 114.6M edges
numpy takes about a minute for the two.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass
class CSRGraph:
    indptr: np.ndarray  # i64[N+1]
    indices: np.ndarray  # i32[nnz]
    feats: np.ndarray  # f32[N, F]
    coords: np.ndarray  # f32[N, C]
    labels: np.ndarray  # i32[N]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def make_powerlaw_graph(
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int = 8,
    coord_dim: int = 3,
    seed: int = 0,
    device=None,
) -> CSRGraph:
    """Hub-biased random graph (degree ~ power law), CSR adjacency; the
    endpoint draw's search and the sort run on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # hub bias: endpoint sampled with prob ∝ zipf rank weight
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.75
    w /= w.sum()
    cdf = w.cumsum()
    cdf /= cdf[-1]
    u = torch.from_numpy(rng.random(n_edges)).to(dev)
    src = torch.searchsorted(torch.from_numpy(cdf).to(dev), u, right=True)
    del u
    dst = torch.from_numpy(rng.integers(0, n_nodes, size=n_edges).astype(np.int32)).to(dev)
    order = torch.sort(src, stable=True).indices
    counts = torch.bincount(src, minlength=n_nodes)
    del src
    indices = dst[order].cpu().numpy()
    del dst, order
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = torch.cumsum(counts, 0).cpu().numpy()
    feats = rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32)
    coords = rng.uniform(0, 1, (n_nodes, coord_dim)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return CSRGraph(indptr, indices, feats, coords, labels)


def pad_edges(n_edges: int, multiple: int = 512) -> int:
    """Edges padded so the edge dim shards over a full 512-chip mesh."""
    return (n_edges + multiple - 1) // multiple * multiple


def _tensors(arrays: dict, dev: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in arrays.items()}


def full_graph_batch(g: CSRGraph, edge_multiple: int = 512, device=None) -> dict:
    """Full-batch training input (edge list from CSR, padded+masked): the
    receivers ascend (CSR order)."""
    dev = resolve_device(device)
    n = g.n_nodes
    senders = g.indices.astype(np.int32)
    receivers = np.repeat(
        np.arange(n, dtype=np.int32), np.diff(g.indptr).astype(np.int64)
    )
    E = len(senders)
    Ep = pad_edges(E, edge_multiple)
    mask = np.zeros((Ep,), bool)
    mask[:E] = True
    s_pad = np.zeros((Ep,), np.int32); s_pad[:E] = senders
    r_pad = np.zeros((Ep,), np.int32); r_pad[:E] = receivers
    return _tensors({
        "feats": g.feats, "coords": g.coords, "senders": s_pad, "receivers": r_pad,
        "edge_mask": mask, "labels": g.labels,
    }, dev)


@dataclass
class SampledShape:
    """Static shape of a fanout-sampled subgraph."""

    batch_nodes: int
    fanouts: tuple[int, ...]

    @property
    def max_nodes(self) -> int:
        n, tot = self.batch_nodes, self.batch_nodes
        for f in self.fanouts:
            n = n * f
            tot += n
        return tot

    @property
    def max_edges(self) -> int:
        n, tot = self.batch_nodes, 0
        for f in self.fanouts:
            tot += n * f
            n = n * f
        return tot


def sample_subgraph(g: CSRGraph, shape: SampledShape, seed: int, step: int,
                    device=None) -> dict:
    """Fanout neighbor sampling (GraphSAGE): returns padded local-id arrays.

    Seeds = batch_nodes random labeled nodes; for each hop, ``fanout``
    uniform neighbors per frontier node.  Node 0..n_sub-1 are relabeled
    locally; padding rows carry mask 0.  The sampling is the reference's
    numpy, on the host.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2**63))
    seeds = rng.integers(0, g.n_nodes, shape.batch_nodes).astype(np.int32)
    edges_s, edges_r = [], []
    local = {int(v): i for i, v in enumerate(seeds)}
    frontier = seeds
    for f in shape.fanouts:
        new = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = rng.integers(lo, hi, min(f, 64))
            for t in take[:f]:
                u = int(g.indices[t])
                if u not in local:
                    local[u] = len(local)
                    new.append(u)
                edges_s.append(local[u])
                edges_r.append(local[int(v)])
        frontier = np.array(new, dtype=np.int32) if new else np.array([], np.int32)

    n_sub = len(local)
    ids = np.fromiter(local.keys(), dtype=np.int64, count=n_sub)
    N, E = shape.max_nodes, shape.max_edges
    feats = np.zeros((N, g.feats.shape[1]), np.float32)
    coords = np.zeros((N, g.coords.shape[1]), np.float32)
    labels = np.full((N,), -1, np.int32)
    feats[:n_sub] = g.feats[ids]
    coords[:n_sub] = g.coords[ids]
    labels[: shape.batch_nodes] = g.labels[ids[: shape.batch_nodes]]
    senders = np.zeros((E,), np.int32)
    receivers = np.zeros((E,), np.int32)
    mask = np.zeros((E,), bool)
    ne = min(len(edges_s), E)
    senders[:ne] = edges_s[:ne]
    receivers[:ne] = edges_r[:ne]
    mask[:ne] = True
    return _tensors({
        "feats": feats, "coords": coords, "senders": senders, "receivers": receivers,
        "edge_mask": mask, "labels": labels,
    }, dev)


def molecule_batch(
    n_graphs: int, nodes_per: int, edges_per: int, d_feat: int, seed: int, step: int = 0,
    device=None,
) -> dict:
    """Batch of small molecules as one block-diagonal graph + graph_ids."""
    dev = resolve_device(device)
    rng = np.random.default_rng((seed * 7_919 + step) % (2**63))
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    feats = rng.normal(0, 1, (N, d_feat)).astype(np.float32)
    coords = rng.normal(0, 1, (N, 3)).astype(np.float32)
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    s = rng.integers(0, nodes_per, E).astype(np.int32) + offs
    r = rng.integers(0, nodes_per, E).astype(np.int32) + offs
    graph_ids = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    # synthetic regression target: mean pairwise distance proxy
    targets = coords.reshape(n_graphs, nodes_per, 3).std(axis=(1, 2)).astype(np.float32)
    return _tensors({
        "feats": feats, "coords": coords,
        # the reference's i64 sums become i32 ids on its device, as here
        "senders": s.astype(np.int32), "receivers": r.astype(np.int32),
        "edge_mask": np.ones((E,), bool), "graph_ids": graph_ids, "targets": targets,
    }, dev)
