"""Logical-axis sharding rules → partition specs (port of
``repro/sharding/specs.py``).

Models annotate every parameter and activation with *logical* dimension
names ("batch", "heads", "ffn", "vocab", "experts", …).  A rules table maps
logical names to candidate mesh axes; :func:`logical_spec` resolves them
against a mesh (skipping axes the mesh does not have, never using one mesh
axis twice in a spec, and skipping an axis that does not divide the
dimension).  The same model code then describes its layout on
``(data, model)``, ``(pod, data, model)`` or one card.

The reference builds ``jax.sharding`` objects; here :class:`PartitionSpec`
is a tuple of the same entries (``None``, an axis name, or a tuple of
joined axis names) and :class:`NamedSharding` pairs it with the port's
:class:`~repro_torch.core.distributed.Mesh` to give each device's
``shard_shape``.  The port's models run on one card; the specs feed the
dry-run (``repro_torch.launch.dryrun``) and the mesh across cards.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

# Default logical-axis → mesh-axes table, the reference's entry for entry.
# Tuple values are *joined* mesh axes (e.g. batch is sharded over pod AND
# data).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "embed": (),  # d_model replicated by default
    "seq": ("model",),  # sequence parallelism: saved activations shard over model
    "docs": ("pod", "data"),  # geo engine: document shards
    "queries": ("model",),  # geo engine: query replicas
    "edges": ("pod", "data", "model"),  # GNN: edge partitioning
    "nodes": ("pod", "data", "model"),  # GNN node-sharded state (shard_map path)
    "rows": ("model",),  # recsys embedding-table rows
    "candidates": ("pod", "data"),  # retrieval candidate sharding
    "layers": (),
    "expert_ffn": (),
    "stage": ("pod",),  # pipeline stages (optional PP)
    "zero1_dim0": ("data",),  # ZeRO-1 optimizer-moment sharding
    "qkv_out": ("model",),  # flattened H*Dh projection output (TP column)
    "kv_out": ("model",),  # flattened KVH*Dh projection output
    "head_dim": ("model",),  # per-head feature dim (KV-cache fallback shard)
    "kv_seq": ("pod", "data"),  # KV-cache sequence dim (long-context decode)
}


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of joined axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec uses, in order."""
        return tuple(a for e in self if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` on a mesh."""

    mesh: object  # repro_torch.core.distributed.Mesh
    spec: PartitionSpec

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """One device's block of a tensor of global ``shape``; each
        dimension must divide by the product of its axes' sizes."""
        sizes = self.mesh.shape
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than shape {shape}")
        out = []
        for i, dim in enumerate(shape):
            e = self.spec[i] if i < len(self.spec) else None
            n = math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else (e or ())))
            if dim % n:
                raise ValueError(f"dimension {i} of {shape} does not divide over {e} ({n})")
            out.append(dim // n)
        return tuple(out)

    @property
    def n_shards(self) -> int:
        """The devices one tensor is split over (the others hold copies)."""
        return math.prod(self.mesh.shape[a] for a in self.spec.axes())


@dataclass
class ShardingContext:
    mesh: object = None
    rules: dict[str, tuple[str, ...]] = field(default_factory=lambda: dict(DEFAULT_RULES))


_CTX = threading.local()


def get_context() -> ShardingContext:
    if not hasattr(_CTX, "ctx"):
        _CTX.ctx = ShardingContext()
    return _CTX.ctx


class use_sharding:
    """Context manager installing (mesh, rules) for model code."""

    def __init__(self, mesh, rules: dict | None = None):
        self.new = ShardingContext(mesh, dict(rules or DEFAULT_RULES))

    def __enter__(self):
        self.prev = get_context()
        _CTX.ctx = self.new
        return self.new

    def __exit__(self, *exc):
        _CTX.ctx = self.prev
        return False


def logical_spec(
    dims: tuple[str | None, ...],
    mesh_axis_names: tuple[str, ...],
    rules: dict[str, tuple[str, ...]] | None = None,
    shape: tuple[int, ...] | None = None,
    mesh=None,
) -> PartitionSpec:
    """Resolve logical dim names to a :class:`PartitionSpec` for a mesh.

    Shape-aware: a candidate mesh axis is only taken if the cumulative
    shard product still divides the dimension; an indivisible axis is
    dropped and stays available for later dims (a KV cache whose 8 kv-heads
    cannot split over model=16 falls through to head_dim 128, which can).
    """
    rules = rules or get_context().rules
    sizes = mesh.shape if mesh is not None else {}
    used: set[str] = set()
    out = []
    for i, d in enumerate(dims):
        if d is None:
            out.append(None)
            continue
        dim_size = shape[i] if shape is not None else None
        axes = []
        prod = 1
        for a in rules.get(d, ()):
            if a not in mesh_axis_names or a in used:
                continue
            a_size = sizes.get(a)
            if dim_size is not None and a_size is not None:
                if dim_size % (prod * a_size) != 0:
                    continue
                prod *= a_size
            axes.append(a)
        used.update(axes)
        if len(axes) == 0:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return PartitionSpec(*out)


def named_sharding(
    mesh,
    dims: tuple[str | None, ...],
    rules=None,
    shape: tuple[int, ...] | None = None,
) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(dims, mesh.axis_names, rules, shape, mesh))


def shard(x, *dims: str | None):
    """Annotate ``x`` with its logical sharding under the current mesh
    context (its ``sharding`` attribute); a no-op without one.  On one card
    nothing moves: the annotation is what the reference's
    ``with_sharding_constraint`` would impose across cards."""
    ctx = get_context()
    if ctx.mesh is None:
        return x
    x.sharding = named_sharding(ctx.mesh, tuple(dims), ctx.rules, tuple(x.shape))
    return x
