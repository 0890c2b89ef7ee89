"""The current mesh, activation-sharding hints and local regions.

Port of ``repro.distributed.hints`` on DTensor.  A ``DeviceMesh`` with
named dims takes the place of the JAX mesh, a list of DTensor placements
(``Shard(d)`` or ``Replicate()`` per mesh dim) that of a
``PartitionSpec``, and ``DTensor.redistribute`` that of
``with_sharding_constraint``.

``use_mesh(mesh)`` is the context the train loop and the dry-run enter:
it makes ``mesh`` current for the hints and lets plain tensors built
inside the model (positions, masks, RoPE and sinusoid tables) mix with
DTensors as replicated values (``implicit_replication``).  Outside it
there is no mesh, and every hint returns its input.

``hint(x, *axes)`` names a logical axis per dim of ``x``: ``"batch"``
means the ``("pod", "data")`` axes present in the mesh, ``"model"`` the
model axis, None unsharded.  A dim that does not divide its axes stays
unsharded.  On a plain ``torch.Tensor``, or without a mesh, it returns
``x`` itself; on a DTensor it redistributes ``x`` to those placements
(a Partial placement is summed on the way: an all-reduce, or a
reduce-scatter onto a sharded dim).

``local_call(fn, args, in_axes, out_axes)`` runs ``fn`` on each rank's
local tensors, for what DTensor cannot partition by itself (the CUDA
kernels, the recurrences' step loops, MoE dispatch and combine), as
GSPMD does around an unpartitionable ``pallas_call``; ``dtensor_local``
makes a function of tensors do so whenever it is given a DTensor.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

#: one entry of a sharding spec: None, a mesh axis name, or a tuple of
#: names (major to minor, as in JAX)
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the current mesh (None: no mesh) for the body."""
    token = _MESH.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with implicit_replication():
                yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost ``use_mesh``, or None."""
    return _MESH.get()


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a ``sharding.AbstractMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes that shard the batch: ``("pod", "data")`` where present."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def entry_names(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> List[Any]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim d is sharded over, ``Replicate()`` on the
    rest.  A dim sharded over several axes takes them in the spec's
    order, the first the major one, as JAX lays out ``("pod", "data")``."""
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for n in entry_names(entry):
            out[names.index(n)] = Shard(d)
    return out


def _resolve(axis: Optional[str], sizes: Dict[str, int]
             ) -> Optional[Tuple[str, ...]]:
    if axis is None:
        return None
    if axis == "batch":
        names = tuple(a for a in ("pod", "data") if a in sizes)
        return names or None
    if axis in sizes:
        return (axis,)
    return None


def _size(names: Sequence[str], sizes: Dict[str, int]) -> int:
    return math.prod(sizes[n] for n in names)


def _entry(names: Tuple[str, ...]) -> SpecEntry:
    return names if len(names) > 1 else names[0]


def hint_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
              mesh) -> Spec:
    """The spec ``hint`` gives a tensor of ``shape`` on ``mesh``."""
    sizes = axis_sizes(mesh)
    spec: List[SpecEntry] = []
    for dim, ax in zip(shape, axes):
        names = _resolve(ax, sizes)
        if names is None:
            spec.append(None)
            continue
        size = _size(names, sizes)
        spec.append(_entry(names) if size > 1 and dim % size == 0 else None)
    return tuple(spec)


def hint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the logical ``axes``; ``x``
    itself without a mesh, on a plain tensor or on a rank mismatch."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor) or len(axes) != x.ndim:
        return x
    pl = placements(hint_spec(x.shape, axes, mesh), mesh)
    if list(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def hint_any(x: torch.Tensor, specs: Sequence[Sequence[Optional[str]]]
             ) -> torch.Tensor:
    """Apply the first spec whose named dims all divide (a priority
    list; the reference's attention scores prefer heads over the model
    axis and fall back to the key sequence).  The port's attention core
    runs in a local region instead (``models.layers._sdpa``)."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    for spec in specs:
        if len(spec) != x.ndim:
            continue
        ok = True
        for dim, ax in zip(x.shape, spec):
            if ax is None:
                continue
            names = _resolve(ax, sizes)
            if names is None:
                ok = False
                break
            size = _size(names, sizes)
            if size > 1 and dim % size != 0:
                ok = False
                break
        if ok:
            return hint(x, *spec)
    return x


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    region's input gradients come out of its ops' backward transposed or
    permuted, and DTensor's decomposed ``view`` of such a local tensor
    (in a matmul's backward outside the region) fails on a mesh of
    several ranks.  The copy changes the layout the backward's products
    see, so a one-rank mesh's backward may pick other matmul kernels
    than the mesh-less path's and differ from it in the last bits."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_call(fn: Callable, args: Sequence[Any],
               in_axes: Sequence[Optional[Sequence[Optional[str]]]],
               out_axes: Sequence[Sequence[Optional[str]]],
               mesh=None, **kwargs) -> Any:
    """``fn(*local args, **kwargs)`` on each rank, wrapped back as
    DTensors.

    ``in_axes[i]`` names a logical axis per dim of ``args[i]`` (None for
    an argument passed as it is, such as None or a number); ``out_axes[j]``
    does so for output j (``fn`` returns one tensor or a tuple).  A
    logical axis takes effect only where every dim that names it divides
    its mesh axes, so GQA's q and k heads split together or not at all.
    Each DTensor argument is redistributed to its axes (the rest of the
    mesh replicated), a plain tensor taken as replicated.  The mesh dims
    some argument is sharded over split the work: an output not sharded
    over such a dim is the sum of the ranks' parts (``Partial``), as the
    MLP's output after a column- then row-sharded product, or the MoE's
    per-expert counts over a sharded batch.  Under autograd a replicated
    argument's gradient is likewise the sum of the ranks' parts."""
    mesh = mesh or current_mesh() or next(
        a.device_mesh for a in args if isinstance(a, DTensor))
    sizes = axis_sizes(mesh)
    active: Dict[str, bool] = {}
    for a, axes in zip(args, in_axes):
        if axes is None:
            continue
        for dim, ax in zip(a.shape, axes):
            names = _resolve(ax, sizes)
            if names is None:
                continue
            size = _size(names, sizes)
            active[ax] = active.get(ax, True) and size > 1 \
                and dim % size == 0

    def spec_of(axes) -> Spec:
        return tuple(_entry(_resolve(ax, sizes)) if active.get(ax) else None
                     for ax in axes)

    split = {n for ax, on in active.items() if on
             for n in _resolve(ax, sizes)}
    dims = list(mesh.mesh_dim_names)

    def summed(pl: List[Any]) -> List[Any]:
        return [Partial() if isinstance(p, Replicate) and n in split else p
                for p, n in zip(pl, dims)]

    local = []
    for a, axes in zip(args, in_axes):
        if axes is None:
            local.append(a)
            continue
        pl = placements(spec_of(axes), mesh)
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * len(dims),
                                   run_check=False)
        if list(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        t = a.to_local(grad_placements=summed(pl)).contiguous()
        local.append(_ContiguousGrad.apply(t))
    outs = fn(*local, **kwargs)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(
        DTensor.from_local(o, mesh, summed(placements(spec_of(axes), mesh)),
                           run_check=False)
        for o, axes in zip(outs, out_axes))
    return wrapped[0] if single else wrapped


def dtensor_local(in_axes: Sequence[Optional[Sequence[Optional[str]]]],
                  out_axes: Sequence[Sequence[Optional[str]]]
                  ) -> Callable[[Callable], Callable]:
    """Decorate a function of tensors so that, given a DTensor among its
    positional arguments, it runs through ``local_call`` on the local
    shards (keyword arguments passed as they are); plain tensors call it
    directly.  An entry of ``in_axes`` may be a function of the argument
    (for an argument whose rank varies)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not any(isinstance(a, DTensor) for a in args):
                return fn(*args, **kwargs)
            axes = [(ax(a) if callable(ax) else ax)
                    if isinstance(a, torch.Tensor) else None
                    for a, ax in zip(args, in_axes)]
            return local_call(fn, args, axes, out_axes, **kwargs)
        return call
    return wrap


def local_offset(x: DTensor) -> Tuple[int, ...]:
    """The global index, per dim, of the first element of this rank's
    shard of ``x`` (its sharded dims divide their mesh axes; a dim
    sharded over several mesh dims splits major to minor)."""
    mesh = x.device_mesh
    off = [0] * x.ndim
    span = list(x.shape)
    for d, p in enumerate(x.placements):
        if isinstance(p, Shard):
            span[p.dim] //= mesh.size(d)
            off[p.dim] += mesh.get_local_rank(d) * span[p.dim]
    return tuple(off)


def write_slice(dst: DTensor, dim: int, start: int,
                src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` in place on a DTensor:
    each rank writes into its shard the part of ``src`` that the shard
    holds.  (DTensor gathers a slice of a sharded dim into a new tensor,
    so a write through such a slice would be lost.)"""
    mesh = dst.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in dst.placements]
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    src = src.redistribute(mesh, pl).to_local()
    local = dst.to_local()
    t0 = local_offset(dst)[dim]
    lo = max(start, t0)
    hi = min(start + src.shape[dim], t0 + local.shape[dim])
    if lo < hi:
        local.narrow(dim, lo - t0, hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


def to_plain(x: Any) -> Any:
    """A DTensor's full value as a plain tensor (a collective: every
    rank of its mesh calls it); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x
