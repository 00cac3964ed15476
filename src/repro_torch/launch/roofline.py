"""Roofline model of one step on H100s (port of ``repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds, per device:

    compute    = Σ_dtype FLOPs_dtype per device / peak FLOP/s of that dtype
    memory     = bytes per device / HBM bandwidth
    collective = collective bytes per device / link bandwidth

They are a model from data-sheet constants, not a measurement.  The
reference reads XLA's cost analysis of the compiled, SPMD-partitioned
program and parses its collectives from HLO text; torch has neither, so
the port counts from a trace of its own eager step (:func:`count_step`,
on the ``meta`` device: nothing is allocated) and from the specs:

* **FLOPs**: ``torch.utils.flop_counter``'s formulas (2·m·n·k per
  matmul; ``mm``, ``bmm``, ``addmm``, convolutions, attention kernels),
  each op's count under the dtype of its operands, whose peak bounds it.
  Elementwise ops count nothing (XLA counted them).
* **bytes**: every op that is not a view counts the bytes of its tensor
  inputs plus its outputs: the eager program's unfused traffic.  XLA
  counted its fused program, where a chain of elementwise ops reads its
  inputs and writes its output once; here each link of the chain counts.
  L2 (50 MB) serves an eager chain's small intermediates, so a step can
  run faster than this byte term (its ``roofline_fraction`` above 1).
* **memory**: the bytes of the storages alive over the trace, the
  arguments from the start: its peak.  An argument the step updates in
  place (``Cell.donate``) allocates nothing, so it is counted once, as the
  reference subtracts ``alias_size_in_bytes``.
* **per device**: each tensor carries the mesh axes it is split over, an
  argument those of its spec, an op's outputs the union of its inputs'
  (what SPMD propagation gives an elementwise op, or a matmul of operands
  split on different dimensions), a factory's output none (counted whole
  on every device: an over-estimate).  An op's FLOPs and bytes, and a
  storage's live bytes, are divided by the product of their axes' sizes.
  Arguments per device are exact (their shard shapes).

**Collectives** come from the specs, not from a compiled program, under
the reference's keys and payload convention (an all-reduce or all-gather
counts its output, a reduce-scatter its input; a group of one device
moves nothing), per device and step:

* ``all-reduce`` of each row gathered from an embedding table split over
  the mesh along its rows (the trace finds the lookups: each device holds
  part of the rows and the others' partial rows are zero);
* train steps, gradient synchronisation over the batch axes ("pod",
  "data") for each parameter leaf replicated there, read from the
  optimizer moments' shardings: where a moment is split over "data" and
  its leaf is not (ZeRO-1, the train cells' ``TRAIN_OPT``), a
  ``reduce-scatter`` of the gradient shard and an ``all-gather`` of the
  updated parameter over "data", and an ``all-reduce`` of the scattered
  shard over "pod"; otherwise an ``all-reduce`` of the gradient shard;
* LMs, per layer, an ``all-reduce`` of the ``[B, S, D]`` activations (in
  the compute dtype) after each projection whose contracted dimension is
  split over "model" (attention's ``wo``, the dense FFN's ``wo``), and an
  ``all-to-all`` of the MoE dispatch buffer ``[B, E·C, D]`` each way
  when the experts are split; forward once, and in a train step the
  backward and the remat recompute (``remat="full"``) once more each;
* EGNN, per layer, an ``all-reduce`` of the receivers' sum ``[N, H + 3]``
  of edge-split messages (nodes replicated), or an ``all-gather`` of the
  node state and a ``reduce-scatter`` of the sum (``gnn_full``, nodes
  split); a train step's backward once more each;
* geoweb, the serve step's merge: per doc axis (innermost first) an
  ``all-gather`` of each query's top-k ids and scores (8 B per entry),
  and an ``all-reduce`` of the per-query counters over the doc axes.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.core.distributed import mesh_axes
from repro_torch.sharding.specs import PartitionSpec

# NVIDIA H100 SXM5 (80 GB HBM3) data sheet, dense rates without sparsity,
# at the full 700 W: bf16 and fp16 tensor cores 989 TFLOP/s; f32 outside
# the tensor cores 67 TFLOP/s (the port's f32 matmuls run without TF32)
PEAK_FLOPS = {
    torch.bfloat16: 989e12,
    torch.float16: 989e12,
    torch.float32: 67e12,
}
HBM_BW = 3.35e12  # bytes/s, HBM3 (same data sheet)
# One conservative link figure: NDR InfiniBand, 400 Gb/s per GPU (one
# ConnectX-7 port each).  The production meshes' model axis of 16 spans two
# 8-GPU NVLink nodes, so its collectives cross that network; NVLink (900
# GB/s per GPU) is not the bound of a 16-wide group
LINK_BW = 50e9  # bytes/s

def peak_flops(dtype: torch.dtype) -> float:
    if dtype not in PEAK_FLOPS:
        raise KeyError(f"no H100 peak for matmuls in {dtype}")
    return PEAK_FLOPS[dtype]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def tensor_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensor_leaves(x)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in tensor_leaves(getattr(tree, f.name))]
    return []


def _axes_of(t: torch.Tensor, mesh) -> frozenset:
    sh = getattr(t, "sharding", None) if mesh is not None else None
    return frozenset(sh.spec.axes()) if sh is not None else frozenset()


def arg_counts(args: tuple, mesh=None, donate: tuple = ()) -> dict:
    """The arguments' bytes, whole and per device on ``mesh`` (from their
    shardings: exact shard shapes), and the step's I/O bytes: every
    argument read once, every donated one written once."""
    out = {"arg_bytes": 0, "arg_bytes_dev": 0.0, "io_bytes": 0}
    for pos, a in enumerate(args):
        for t in tensor_leaves(a):
            nb = t.numel() * t.element_size()
            sh = getattr(t, "sharding", None) if mesh is not None else None
            out["arg_bytes"] += nb
            out["arg_bytes_dev"] += nb / (sh.n_shards if sh is not None else 1)
            out["io_bytes"] += nb * (2 if pos in donate else 1)
    return out


@dataclass
class StepCount:
    """One traced step's counts: global (one device running it all) and
    per device (each tensor over its axes' product, see the module's
    docstring)."""

    flops: dict[str, int] = field(default_factory=dict)  # by operand dtype
    flops_dev: dict[str, float] = field(default_factory=dict)
    bytes: int = 0
    bytes_dev: float = 0.0
    arg_bytes: int = 0  # every argument tensor's bytes
    arg_bytes_dev: float = 0.0
    io_bytes: int = 0  # arguments read once + donated ones written once
    peak: int = 0  # live bytes, arguments included
    peak_dev: float = 0.0
    # rows gathered from tables split along their rows: per-device payload
    # bytes by the axes (sorted tuple) the table is split over
    lookups_dev: dict[tuple, float] = field(default_factory=dict)
    n_ops: int = 0

    @property
    def flops_total(self) -> int:
        return sum(self.flops.values())

    @property
    def transient(self) -> int:
        return self.peak - self.arg_bytes

    @property
    def transient_dev(self) -> float:
        return self.peak_dev - self.arg_bytes_dev


class _Counter(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage bytes of every op it sees."""

    def __init__(self, sizes: dict[str, int]):
        super().__init__()
        self.sizes = sizes
        self.c = StepCount()
        self.live: dict[int, tuple[int, frozenset]] = {}
        self.cur = 0
        self.cur_dev = 0.0
        self.arg_keys: dict[int, int] = {}  # storage → argument position
        self.table_axes: dict[int, tuple] = {}  # storage → row axes of a table arg
        self.written: set[int] = set()
        self._refs: list = []

    def factor(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def _key(self, t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def axes(self, t: torch.Tensor) -> frozenset:
        hit = self.live.get(self._key(t))
        return hit[1] if hit is not None else frozenset()

    def add_storage(self, t: torch.Tensor, axes: frozenset) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        nb = st.nbytes()
        self.live[key] = (nb, axes)
        self.cur += nb
        self.cur_dev += nb / self.factor(axes)
        self.c.peak = max(self.c.peak, self.cur)
        self.c.peak_dev = max(self.c.peak_dev, self.cur_dev)

        def freed(_ref, key=key):
            hit = self.live.pop(key, None)
            if hit is not None:
                self.cur -= hit[0]
                self.cur_dev -= hit[0] / self.factor(hit[1])

        self._refs.append(weakref.ref(st, freed))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.c
        c.n_ops += 1
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        in_axes = frozenset().union(*(self.axes(t) for t in ins))
        writes = False
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                writes = True
                v = args[i] if i < len(args) else kwargs.get(a.name)
                if isinstance(v, torch.Tensor) and self._key(v) in self.arg_keys:
                    self.written.add(self.arg_keys[self._key(v)])
        if func.overloadpacket in flop_registry:
            n = flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
            mats = [t for t in ins if t.dim() >= 2] or ins
            dt = _dtype_name(mats[0].dtype)
            c.flops[dt] = c.flops.get(dt, 0) + n
            c.flops_dev[dt] = c.flops_dev.get(dt, 0.0) + n / self.factor(in_axes)
        in_keys = {self._key(t) for t in ins}
        if func.is_view or (not writes and all(self._key(o) in in_keys for o in outs)):
            return out  # an alias of an input moves no bytes
        if func.overloadpacket in (torch.ops.aten.embedding, torch.ops.aten.index_select,
                                   torch.ops.aten.index) and ins:
            rows = self.table_axes.get(self._key(ins[0]))
            if rows and outs:
                o = outs[0]
                per = o.numel() * o.element_size() / self.factor(in_axes - frozenset(rows))
                c.lookups_dev[rows] = c.lookups_dev.get(rows, 0.0) + per
        for t in ins:
            nb = t.numel() * t.element_size()
            c.bytes += nb
            c.bytes_dev += nb / self.factor(self.axes(t))
        for o in outs:
            nb = o.numel() * o.element_size()
            c.bytes += nb
            known = self.live.get(self._key(o))
            c.bytes_dev += nb / self.factor(known[1] if known is not None else in_axes)
            self.add_storage(o, in_axes)
        return out


def count_step(fn, args: tuple, mesh=None, donate: tuple = ()) -> StepCount:
    """Trace ``fn(*args)`` (meta tensors, each with its ``sharding`` when
    ``mesh`` is given) and count it (:class:`StepCount`).  Raises if the
    step writes an argument that ``donate`` does not name, or if the
    per-dtype FLOPs do not add up to ``FlopCounterMode``'s total."""
    sizes = mesh.shape if mesh is not None else {}
    mode = _Counter(sizes)
    c = mode.c
    counts = arg_counts(args, mesh, donate)
    c.arg_bytes, c.arg_bytes_dev, c.io_bytes = (
        counts["arg_bytes"], counts["arg_bytes_dev"], counts["io_bytes"])
    for pos, a in enumerate(args):
        for t in tensor_leaves(a):
            mode.add_storage(t, _axes_of(t, mesh))
            mode.arg_keys[mode._key(t)] = pos
            # an embedding table split along its rows (any dim but the last)
            sh = getattr(t, "sharding", None) if mesh is not None else None
            if sh is not None and t.dim() >= 2:
                rows = PartitionSpec(*sh.spec[:t.dim() - 1]).axes()
                if rows:
                    mode.table_axes[mode._key(t)] = tuple(sorted(rows))
    with FlopCounterMode(display=False) as fc:
        with mode:
            fn(*args)
    total = fc.get_total_flops()
    if c.flops_total != total:
        raise RuntimeError(f"FLOPs by dtype add to {c.flops_total}, FlopCounterMode counted "
                           f"{total}")
    extra = sorted(mode.written - set(donate))
    if extra:
        raise ValueError(f"the step writes argument(s) {extra}, which the cell does not donate")
    return c


# ---------------------------------------------------------------------------
# collectives (the model of the module docstring)
# ---------------------------------------------------------------------------

def _add(out: dict, kind: str, nbytes: float) -> None:
    if nbytes > 0:
        out[kind] = out.get(kind, 0.0) + nbytes


def _group(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _shard_bytes(t: torch.Tensor) -> float:
    return math.prod(t.sharding.shard_shape(tuple(t.shape))) * t.element_size()


def grad_sync_bytes(params: dict, moments: dict, mesh) -> dict:
    """Per-device gradient synchronisation of a train step: each parameter
    leaf's gradient shard, synchronised as the leaf's optimizer moment
    (``moments``, the optimizer state's ``m``) is split: its ``sharding``
    is ZeRO-1's when the cell's optimizer shards the moments."""
    out: dict = {}
    batch_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    for p, m in zip(tensor_leaves(params), tensor_leaves(moments), strict=True):
        if p.shape != m.shape:
            raise ValueError(f"moment of shape {tuple(m.shape)} for a leaf of {tuple(p.shape)}")
        free = [a for a in batch_axes if a not in p.sharding.spec.axes()]
        if _group(mesh, free) == 1:
            continue
        b = _shard_bytes(p)
        if "data" in free and "data" in m.sharding.spec.axes() and mesh.shape["data"] > 1:
            _add(out, "reduce-scatter", b)
            _add(out, "all-gather", b)
            rest = [a for a in free if a != "data"]
            if _group(mesh, rest) > 1:
                _add(out, "all-reduce", b / mesh.shape["data"])
        else:
            _add(out, "all-reduce", b)
    return out


def _model_split(t: torch.Tensor, dim: int) -> bool:
    e = t.sharding.spec[dim] if dim < len(t.sharding.spec) else None
    return e is not None and "model" in ((e,) if isinstance(e, str) else e)


def lm_activation_bytes(cfg, kind: str, B: int, S: int, params: dict, mesh, batch_split: int):
    """Per-device tensor- and expert-parallel traffic of an LM step."""
    out: dict = {}
    if "model" not in mesh.axis_names or mesh.shape["model"] == 1:
        return out
    passes = 3 if kind == "lm_train" and cfg.remat == "full" else (2 if kind == "lm_train" else 1)
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    act = B * S * cfg.d_model * item / batch_split
    lay = params["layers"]
    per_layer = 0.0
    if _model_split(lay["attn"]["wo"], 1):
        per_layer += act
    if not cfg.is_moe and _model_split(lay["mlp"]["wo"], 1):
        per_layer += act
    _add(out, "all-reduce", passes * cfg.n_layers * per_layer)
    if cfg.is_moe and _model_split(lay["moe"]["wi_gate"], 1):
        from repro_torch.models.moe import capacity

        buf = B * cfg.n_experts * capacity(cfg, S) * cfg.d_model * item / batch_split
        _add(out, "all-to-all", passes * cfg.n_layers * 2 * buf)
    return out


def egnn_bytes(cfg, kind: str, n_nodes: int, mesh) -> dict:
    """Per-device traffic of EGNN's edge-split sums (train step)."""
    out: dict = {}
    axes = [a for a in ("pod", "data", "model") if a in mesh.axis_names]
    n = _group(mesh, axes)
    if n == 1:
        return out
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    state = n_nodes * (cfg.d_hidden + cfg.coord_dim) * item
    if kind == "gnn_full":  # nodes split: gather the state, scatter the sums
        _add(out, "all-gather", 2 * cfg.n_layers * state)
        _add(out, "reduce-scatter", 2 * cfg.n_layers * state)
    else:  # nodes replicated: the forward sum, the two gathers' backward
        _add(out, "all-reduce", 3 * cfg.n_layers * state)
    return out


def geoweb_bytes(cfg, mesh, n_counters: int) -> dict:
    """Per-device traffic of the geoweb serve step's merge."""
    out: dict = {}
    doc_axes, query_axis = mesh_axes(mesh)
    b_loc = cfg.query_batch / mesh.shape[query_axis]
    k = cfg.budgets.top_k
    doc_axes = doc_axes[::-1]  # innermost first
    for a in doc_axes:
        if mesh.shape[a] > 1:
            _add(out, "all-gather", b_loc * k * 8 * mesh.shape[a])
    if _group(mesh, doc_axes) > 1:
        _add(out, "all-reduce", b_loc * n_counters * 4)
    return out


# ---------------------------------------------------------------------------
# the roofline row
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: dict[str, float]  # by operand dtype name
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: dict[str, float]
    model_flops: float  # analytic useful flops, GLOBAL
    model_dtype: str  # the dtype whose peak bounds the useful flops
    mem_per_dev_bytes: float
    note: str = ""

    @property
    def t_compute(self) -> float:
        return sum(f / peak_flops(_dtype_of(d)) for d, f in self.flops_per_dev.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        total = sum(self.flops_per_dev.values()) * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The useful FLOPs' time at peak over the dominant term:
        (model_flops / n_dev / peak) / max(term)."""
        t_useful = self.model_flops / self.n_devices / peak_flops(_dtype_of(self.model_dtype))
        t_dom = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_dom if t_dom > 0 else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.n_devices,
            "flops/dev": sum(self.flops_per_dev.values()),
            "flops_by_dtype/dev": self.flops_per_dev,
            "bytes/dev": self.bytes_per_dev,
            "coll_bytes/dev": self.coll_bytes_per_dev,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "hbm_per_dev_GB": self.mem_per_dev_bytes / 1e9,
            "collectives": self.coll_breakdown,
            "note": self.note,
        }
