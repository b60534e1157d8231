"""Mesh context + logical-axis sharding rules, ported from ``repro.distributed``.

Model code annotates activations with *logical* axis names; a
``ShardingRules`` object maps them onto the axes of a torch ``DeviceMesh``
(or of the port's ``AbstractMesh``, which has no process group and serves
the spec factories and tests).  The production meshes are (16, 16) ->
("data", "model") and (2, 16, 16) -> ("pod", "data", "model"); one device
uses a (1, 1) mesh with the same names, so there is one model code path.

Logical axes:
  batch     -- data parallel (pod+data)
  fsdp      -- weight/optimizer sharding over the data axis (ZeRO-style)
  tp        -- tensor parallel (heads / ffn / experts / vocab)
  seq       -- the model axis shards tokens under ``seq_parallel``
  none      -- replicated

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of names (major to minor), or None -- the values of the reference's
``PartitionSpec``.  ``to_placements`` turns one into DTensor placements.

The counterparts of the reference's primitives:

* ``shard`` (``with_sharding_constraint``) redistributes a DTensor to the
  spec's placements.  It is the identity without active rules and on a mesh
  of one device, as jax's constraint changes nothing there; the model's
  tensors are then plain tensors.
* ``local_call`` (``shard_map``) runs a function on each rank's local
  shards, its inputs redistributed to the given specs and its outputs
  wrapped as DTensors of the given placements (``Partial`` for a ``psum``
  still to be taken); ``tp_index`` is ``lax.axis_index`` of the tp axis.
* Under active rules on a multi-device mesh, plain tensors that meet a
  DTensor in an op (masks, positions and rope tables made by
  ``torch.arange``) count as replicated (``implicit_replication``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard



class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names, or None.

    A tuple, so it compares equal to the tuple of the reference's
    ``PartitionSpec`` entries; a type of its own, so spec trees can tell a
    spec from a tuple of tensors (whisper's ``enc_kv``).
    """

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec
Spec = PartitionSpec


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices or a process group
    (the counterpart of ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]) -> None:
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names {tuple(axis_names)} differ in length")
        self.axis_sizes = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.axis_sizes}, {self.axis_names})"


def axis_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh: Any) -> tuple[str, ...]:
    return tuple(mesh.axis_names if isinstance(mesh, AbstractMesh) else mesh.mesh_dim_names)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Physical realisation of the logical axes on a concrete mesh."""

    mesh: Any
    #: mesh axes that make up data parallelism, e.g. ("pod", "data")
    dp_axes: tuple[str, ...]
    #: mesh axis for tensor/expert parallelism
    tp_axis: str = "model"
    #: shard parameters & optimizer state over the data axis too (ZeRO/FSDP)
    fsdp: bool = False
    #: sequence parallelism: the model axis shards *tokens* instead of weights
    seq_parallel: bool = False

    @property
    def dp_size(self) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return axis_sizes(self.mesh)[self.tp_axis]

    @property
    def size(self) -> int:
        return math.prod(axis_sizes(self.mesh).values())

    def spec(self, *logical: str | None) -> Spec:
        """Translate logical axis names to a spec (the reference's PartitionSpec values)."""
        phys: list[Any] = []
        for name in logical:
            if name is None or name == "none":
                phys.append(None)
            elif name == "batch":
                phys.append(self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0])
            elif name == "fsdp":
                phys.append(self.dp_axes if (self.fsdp and len(self.dp_axes) > 1)
                            else (self.dp_axes[0] if self.fsdp else None))
            elif name == "tp":
                phys.append(None if self.seq_parallel else self.tp_axis)
            elif name == "seq":
                phys.append(self.tp_axis if self.seq_parallel else None)
            else:
                raise KeyError(f"unknown logical axis {name!r}")
        return P(*phys)

    def sharding(self, *logical: str | None) -> tuple[Placement, ...]:
        """DTensor placements of ``spec(*logical)``."""
        return to_placements(self.mesh, self.spec(*logical), len(logical))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a tensor's placements on it (the counterpart of jax's ``NamedSharding``)."""

    mesh: Any
    placements: tuple[Placement, ...]


def for_mesh(mesh: Any, fsdp: bool = False, seq_parallel: bool = False) -> ShardingRules:
    """Build rules from a mesh made by ``launch.mesh.make_production_mesh``."""
    names = axis_names(mesh)
    dp = tuple(a for a in names if a in ("pod", "data", "replica"))
    tp = "model" if "model" in names else names[-1]
    return ShardingRules(mesh=mesh, dp_axes=dp or (names[0],), tp_axis=tp, fsdp=fsdp, seq_parallel=seq_parallel)


def to_placements(mesh: Any, spec: Spec, ndim: int) -> tuple[Placement, ...]:
    """Placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh dim that
    shards tensor dim ``d``, ``Replicate()`` on the others."""
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    out: list[Placement] = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(entries)
                if e is not None and name in (e if isinstance(e, tuple) else (e,))]
        if len(dims) > 1:
            raise ValueError(f"mesh axis {name!r} shards tensor dims {dims} of spec {spec}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def sanitize_spec(rules: ShardingRules, spec: Spec, shape: Sequence[int]) -> Spec:
    """Drop spec entries that do not divide the corresponding dimension."""
    sizes = axis_sizes(rules.mesh)
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n = math.prod(sizes[a] for a in axes)
        out.append(entry if dim % n == 0 else None)
    return P(*out)


# --------------------------------------------------------------------------------
# Active-rules context: model code calls shard(x, "batch", None, "tp") without
# threading the rules object through every function signature.
# --------------------------------------------------------------------------------
class _State(threading.local):
    rules: ShardingRules | None = None


_STATE = _State()


def is_distributed(rules: ShardingRules | None) -> bool:
    """Whether ``rules`` shard anything: a ``DeviceMesh`` of more than one device."""
    return rules is not None and not isinstance(rules.mesh, AbstractMesh) and rules.size > 1


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    prev = _STATE.rules
    _STATE.rules = rules
    try:
        if is_distributed(rules):
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield rules
        else:
            yield rules
    finally:
        _STATE.rules = prev


def active_rules() -> ShardingRules | None:
    return _STATE.rules


def distributed_rules() -> ShardingRules | None:
    """The active rules if they shard anything, else None (one device, or no rules)."""
    rules = _STATE.rules
    return rules if is_distributed(rules) else None


def from_local(local: torch.Tensor, mesh: Any, placements: Sequence[Placement],
               shape: Sequence[int] | None = None) -> DTensor:
    """``DTensor.from_local`` without a check across ranks; ``shape`` is the
    global shape (default: from the placements)."""
    stride = None
    if shape is not None:
        shape = torch.Size(shape)
        stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))  # contiguous
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False, shape=shape, stride=stride)


def replicate(t: torch.Tensor, mesh: Any | None = None) -> torch.Tensor:
    """A plain tensor, equal on every rank, as a replicated DTensor on the active
    mesh (masks, positions and rope tables); the identity without distributed rules."""
    if isinstance(t, DTensor):
        return t
    if mesh is None:
        rules = distributed_rules()
        if rules is None:
            return t
        mesh = rules.mesh
    return from_local(t, mesh, [Replicate()] * mesh.ndim)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Sharding constraint by logical axis names; the identity without active
    rules or on a mesh of one device.

    Axes whose mesh size does not divide the tensor dim are dropped (e.g. a
    batch of 1 in the long-context decode cell cannot shard over dp=32).
    """
    rules = distributed_rules()
    if rules is None:
        return x
    spec = sanitize_spec(rules, rules.spec(*logical), x.shape)
    return constrain(replicate(x, rules.mesh), spec)


def constrain(x: DTensor, spec: Spec) -> DTensor:
    """Redistribute ``x`` to a physical ``spec`` on its mesh (already sanitized)."""
    placements = to_placements(x.device_mesh, spec, x.ndim)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def spec_of(t: DTensor) -> Spec:
    """The spec of a DTensor's placements (``Partial`` placements count as unsharded)."""
    names = axis_names(t.device_mesh)
    dims: list[list[str]] = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return P(*(None if not d else d[0] if len(d) == 1 else tuple(d) for d in dims))


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def with_partial(mesh: Any, spec: Spec, ndim: int, axes: Sequence[str], op: str = "sum") -> tuple:
    """Placements of ``spec``, with ``Partial(op)`` on the mesh ``axes`` (a sum still to take)."""
    return tuple(Partial(op) if n in axes else p
                 for n, p in zip(axis_names(mesh), to_placements(mesh, spec, ndim)))


def tp_index() -> int:
    """This rank's index along the tp axis (``lax.axis_index``); 0 without distributed rules."""
    rules = distributed_rules()
    return 0 if rules is None else rules.mesh.get_local_rank(rules.tp_axis)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous: a gradient leaving a
    local call becomes a DTensor again, whose views are views of its local
    tensor (a transposed gradient of an einsum cannot be viewed)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn: Callable, inputs: Sequence[tuple[Any, Spec | None]],
               outputs: Sequence[Spec | tuple[Placement, ...]]) -> Any:
    """Run ``fn`` on local shards (the counterpart of ``jax.shard_map``).

    ``inputs``: (value, spec) pairs; a tensor is redistributed to its
    (sanitized) spec and handed over as its local shard; a non-tensor, or a
    spec of None, is passed as it is.  ``outputs``: one spec per output of
    ``fn`` (sanitized against the caller's shapes), or a tuple of placements
    (``Partial`` where ``fn`` leaves a sum or max to take).  Without
    distributed rules ``fn`` runs on the inputs directly.
    """
    rules = distributed_rules()
    if rules is None:
        return fn(*(v for v, _ in inputs))
    mesh = rules.mesh
    placed = [constrain(replicate(v, mesh), spec) if isinstance(v, torch.Tensor) and spec is not None else v
              for v, spec in inputs]
    # the mesh dims the computation is split over: a gradient of an input
    # replicated on one of them is a partial sum there
    split = {d for v in placed if isinstance(v, DTensor) for d, p in enumerate(v.placements)
             if isinstance(p, Shard)}
    args = []
    for value in placed:
        if isinstance(value, DTensor):
            grads = tuple(Partial() if d in split and isinstance(p, Replicate) else p
                          for d, p in enumerate(value.placements))
            value = value.to_local(grad_placements=grads)
        if isinstance(value, torch.Tensor) and value.requires_grad:
            value = _ContiguousGrad.apply(value)
        args.append(value)
    result = fn(*args)
    single = not isinstance(result, tuple)
    results = (result,) if single else result
    if len(results) != len(outputs):
        raise ValueError(f"local_call: {len(results)} outputs for {len(outputs)} specs")
    wrapped = []
    for local, spec in zip(results, outputs):
        if local is None:
            wrapped.append(None)
            continue
        if spec and isinstance(spec[0], Placement):
            placements = spec
        else:
            placements = to_placements(mesh, spec, local.ndim)
        # contiguous: DTensor's views of a result (a reshape) are views of its local tensor
        wrapped.append(from_local(local.contiguous(), mesh, placements,
                                  _global_shape(local.shape, placements, mesh)))
    return wrapped[0] if single else tuple(wrapped)


def _global_shape(local_shape, placements, mesh) -> tuple[int, ...]:
    shape = list(local_shape)
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            shape[p.dim] *= mesh.size(mesh_dim)
    return tuple(shape)


def single_device_rules() -> ShardingRules:
    """A (1, 1) mesh with the production axis names, for one device: every
    ``shard`` is the identity and the model's tensors stay plain tensors."""
    return for_mesh(AbstractMesh((1, 1), ("data", "model")))


def full_tensor(t: Any) -> Any:
    """A DTensor gathered to its full value on every rank; anything else as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t
