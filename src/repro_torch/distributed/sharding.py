"""Sharding rules: DP / FSDP / TP / SP / EP as per-leaf specs.

Port of ``repro.distributed.sharding``: the MaxText-style 2-D scheme on
the ("data", "model") mesh (+ an outer "pod" axis as more data
parallelism), rule for rule:

  * weight matrices: the contraction-side dim sharded over "data" (FSDP,
    from 1024 rows) and the parallel dim over "model" (TP);
  * MoE expert tensors (E, D, F): experts over "model" (EP), D over
    "data";
  * activations and inputs: batch over ("pod", "data");
  * KV caches: batch over the data axes, kv-heads over "model" when they
    divide it, else the sequence (cache sequence parallelism).

A spec is a tuple with one entry per tensor dim (None, an axis name, or
a tuple of names, major first), as a ``PartitionSpec`` padded to the
tensor's rank.  ``NamedSharding(mesh, spec)`` pairs it with a mesh: a
``DeviceMesh``, or an ``AbstractMesh`` of axis sizes alone, on which the
specs and per-device shapes of a production mesh are computed without
its ranks.  ``distribute`` turns a tree of tensors and one of shardings
into DTensors, each rank keeping only its shard.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.hints import (Spec, axis_sizes, batch_axes,
                                           entry_names, placements)
from repro_torch.models.common import ModelConfig
from repro_torch.tree import flatten_with_path, tree_map, unflatten

#: leaf names whose LAST dim is the parallel (TP) dim
_LAST_MODEL = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_x", "w_y",
    "w_r", "w_g", "w_decay", "w_k", "patch_proj", "unembed",
}
#: leaf names whose FIRST (non-stacked) dim is the parallel dim
_FIRST_MODEL = {"wo", "w_down", "w_out", "w_v", "w_o"}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh without its ranks (the torch
    counterpart of ``jax.sharding.AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the leaf of a shardings tree."""
    mesh: Any
    spec: Spec

    def placements(self):
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The per-device shape of a tensor of ``shape`` (a spec shorter
        than the shape leaves the last dims whole)."""
        sizes = axis_sizes(self.mesh)
        out = []
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        for dim, entry in zip(shape, spec):
            n = math.prod(sizes[a] for a in entry_names(entry))
            if dim % n:
                raise ValueError(f"dim {dim} does not divide over {entry} "
                                 f"({n})")
            out.append(dim // n)
        return tuple(out)


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
               scanned: bool) -> Spec:
    """The spec of one parameter leaf."""
    name = path[-1]
    lead: Tuple[Optional[str], ...] = (None,) if scanned else ()
    body = shape[1:] if scanned else shape

    def ok(dim_idx: int, axis: str) -> bool:
        return body[dim_idx] % max(1, _axis_size(mesh, axis)) == 0

    if name == "embed":
        # vocab over model (TP of the embedding / tied unembedding)
        if len(body) == 2 and ok(0, "model"):
            return (*lead, "model", None)
        return (*lead, None, None)

    if len(body) == 3 and name in ("w_gate", "w_up", "w_down"):
        # MoE expert tensors (E, D, F): expert-parallel over "model" plus
        # FSDP of the per-expert matrix over "data"
        e = "model" if ok(0, "model") else None
        d1 = "data" if ok(1, "data") else None
        return (*lead, e, d1, None)

    if len(body) == 2:
        if name in _LAST_MODEL:
            d0 = "data" if ok(0, "data") and body[0] >= 1024 else None
            d1 = "model" if ok(1, "model") else None
            return (*lead, d0, d1)
        if name in _FIRST_MODEL:
            d0 = "model" if ok(0, "model") else None
            d1 = "data" if ok(1, "data") and body[1] >= 1024 else None
            return (*lead, d0, d1)
    return (*lead, *([None] * len(body)))


def _is_scanned(cfg: ModelConfig, path: Tuple[str, ...]) -> bool:
    """Stacked per-layer leaves carry a leading layer axis, except the
    hybrid family's list of per-layer dictionaries."""
    return any(p in ("layers", "enc_layers", "dec_layers") for p in path) \
        and cfg.arch_kind != "hybrid"


def _map_with_path(fn, tree) -> Any:
    return unflatten(tree, [fn(path, leaf)
                            for path, leaf in flatten_with_path(tree)])


def params_shardings(cfg: ModelConfig, params: Any, mesh) -> Any:
    """A ``NamedSharding`` per leaf of a params tree (tensors of any
    device, ``meta`` included); the AdamW moments take the same tree."""
    return _map_with_path(
        lambda path, x: NamedSharding(mesh, param_spec(
            path, tuple(x.shape), mesh, _is_scanned(cfg, path))), params)


def batch_shardings(cfg: ModelConfig, specs: Any, mesh) -> Any:
    """Inputs: the leading (batch) dim over the data axes where it
    divides them; everything else replicated."""
    daxes = batch_axes(mesh)
    dsize = math.prod(_axis_size(mesh, a) for a in daxes)

    def leaf(path, x):
        nd = len(x.shape)
        if nd >= 1 and x.shape[0] % dsize == 0:
            return NamedSharding(mesh, (daxes, *([None] * (nd - 1))))
        return NamedSharding(mesh, (None,) * nd)

    return _map_with_path(leaf, specs)


def cache_shardings(cfg: ModelConfig, cache: Any, mesh) -> Any:
    """The decode cache's shardings.  KV (L, B, T, Hkv, hd): batch over
    the data axes; kv-heads over "model" when they divide it, else the
    sequence.  The hybrid family's per-layer (B, T, H, hd) k and v: batch,
    and the ring's slots over "model" when they divide it.  Recurrent
    states: batch over the data axes, the width over "model" when it
    divides and is at least 64 a rank."""
    msize = _axis_size(mesh, "model")
    daxes = batch_axes(mesh)
    dsize = math.prod(_axis_size(mesh, a) for a in daxes)
    dspec = daxes if len(daxes) > 1 else daxes[0]

    def leaf(path, x):
        shape = tuple(x.shape)
        nd = len(shape)

        def named(*spec):
            return NamedSharding(mesh, tuple(spec))

        if nd == 5:          # (L, B, T, Hkv, hd)
            b = dspec if shape[1] % dsize == 0 else None
            if shape[3] % msize == 0:
                return named(None, b, None, "model", None)
            if shape[2] % msize == 0:
                return named(None, b, "model", None, None)
            return named(None, b, None, None, None)
        if nd == 4 and path and path[-1] in ("k", "v"):  # hybrid (B,T,H,hd)
            b = dspec if shape[0] % dsize == 0 else None
            if shape[1] % msize == 0:
                return named(b, "model", None, None)
            return named(b, None, None, None)
        wide = nd >= 2 and shape[-1] % msize == 0 \
            and shape[-1] >= msize * 64
        if nd >= 2 and shape[0] % dsize == 0:
            spec = [dspec] + [None] * (nd - 1)
        elif nd >= 2 and shape[1] % dsize == 0:
            spec = [None, dspec] + [None] * (nd - 2)
        else:
            return named()
        if wide:
            spec[-1] = "model"
        return named(*spec)

    return _map_with_path(leaf, cache)


def replicated(mesh) -> NamedSharding:
    """Every dim unsharded (a 0-d spec: it fits tensors of any rank)."""
    return NamedSharding(mesh, ())


def _local(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's shard of the full tensor ``t``: each sharded dim cut
    by the rank's coordinates on its axes, in the spec's order (pod
    before data), as ``distribute_tensor`` cuts it."""
    mesh = sharding.mesh
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(sharding.spec):
        for n in entry_names(entry):
            size = sizes[n]
            if t.shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"divide over {n} ({size})")
            step = t.shape[d] // size
            t = t.narrow(d, coord[names.index(n)] * step, step)
    return t


def from_full(t: torch.Tensor, sharding: NamedSharding,
              device=None) -> DTensor:
    """The DTensor of ``sharding`` holding the full tensor ``t``, which
    every rank holds the same: each keeps a contiguous copy of its shard
    (on ``device``, by default ``t``'s), with no communication."""
    local = _local(t, sharding).to(device=device or t.device, copy=True)
    return DTensor.from_local(local.contiguous(), sharding.mesh,
                              sharding.placements(), run_check=False,
                              shape=t.shape, stride=contiguous_stride(t))


def contiguous_stride(t: torch.Tensor) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``t``'s shape."""
    return torch.empty(t.shape, device="meta").stride()


def distribute(tree: Any, shardings: Any, device=None) -> Any:
    """Each tensor of ``tree`` as a DTensor of its sharding (leaves that
    are already DTensors are redistributed)."""
    def leaf(t, sh):
        if isinstance(t, DTensor):
            return t.redistribute(sh.mesh, sh.placements())
        return from_full(t, sh, device)
    return tree_map(leaf, tree, shardings)


def sharding_of(t: DTensor) -> NamedSharding:
    """The spec of a DTensor's placements (no Partial)."""
    names = list(t.device_mesh.mesh_dim_names)
    spec: list = [()] * t.ndim
    for n, p in zip(names, t.placements):
        if p.is_shard():
            spec[p.dim] = spec[p.dim] + (n,)
        elif not p.is_replicate():
            raise ValueError(f"{p} has no spec")
    return NamedSharding(t.device_mesh, tuple(
        None if not e else (e[0] if len(e) == 1 else e) for e in spec))


def abstract_params(cfg: ModelConfig) -> Any:
    """``init_model``'s tree as ``meta`` tensors (shapes and dtypes, no
    storage), drawn under ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.transformer import init_model
    with FakeTensorMode():
        fake = init_model(cfg, device="cpu")
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def init_sharded(cfg: ModelConfig, mesh, seed: int = 0,
                 device=None) -> Any:
    """``init_model``'s parameters as DTensors of ``params_shardings``:
    every rank draws each leaf from ``seed`` the same way and keeps its
    shard (a stacked leaf layer by layer), so the parameters are
    ``init_model``'s, and a rank's peak is its shards and one layer's
    draws.  ``device``: this rank's device (by default the mesh's
    device type, on the current card)."""
    from repro_torch.models.transformer import init_model
    specs = {}

    def keep(path, t, layer_slice):
        shape = ((1,) + tuple(t.shape)) if layer_slice else tuple(t.shape)
        spec = param_spec(path, shape, mesh, _is_scanned(cfg, path))
        specs[path] = spec
        body = NamedSharding(mesh, spec[1:] if layer_slice else spec)
        return _local(t, body).clone()

    local = init_model(cfg, seed, device or mesh.device_type, shard=keep)
    return _map_with_path(
        lambda path, t: DTensor.from_local(
            t, mesh, placements(specs[path], mesh), run_check=False),
        local)
