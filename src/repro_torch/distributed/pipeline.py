"""Pipeline-parallel stage placement: PipeOrgan's spatial organization
at the pod level.

Port of ``repro.distributed.pipeline``.  The paper's chip-level insight
(place the consumer next to the producer; choose blocked vs interleaved
organization by pipelining granularity) maps onto the devices of the
mesh's "model" axis, whose order decides how many link hops every
stage -> stage activation transfer crosses:

  * BLOCKED: stage s owns a contiguous block of devices.  Within-stage
    collectives (TP) stay local, but with several devices a stage the
    handoff jumps a whole block, and microbatch k's transfer contends
    with k+1's on the same links.
  * STRIPED: stages interleave round-robin, so the producer shard of
    stage s and the consumer shard of stage s+1 are neighbours (1 hop),
    at the cost of spreading each stage's TP collectives across the
    array: the paper's locality/flexibility trade-off.

``placement_cost`` scores both against the link bandwidth (on the H100s
of the port, one NVLink link: ``core.hwconfig.H100_NVLINK_BW_PER_LINK``);
``choose_placement`` is the paper's Sec. IV-B rule at pod scale.
``pipeline_spmd_fn`` runs a GPipe forward over the "model" mesh dim,
each stage's output handed to the next stage's device by point-to-point
sends along the placement's permutation.
"""
from __future__ import annotations

import enum
from typing import Any, Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.hwconfig import H100_NVLINK_BW_PER_LINK
from repro_torch.tree import tree_map


class StageOrg(enum.Enum):
    BLOCKED = "blocked"
    STRIPED = "striped"


def stage_of_device(org: StageOrg, n_stages: int, n_devices: int
                    ) -> List[int]:
    """The stage id owning each position along the model axis."""
    dps = n_devices // n_stages
    if org == StageOrg.BLOCKED:
        return [min(i // dps, n_stages - 1) for i in range(n_devices)]
    return [i % n_stages for i in range(n_devices)]


def handoff_permutation(org: StageOrg, n_stages: int, n_devices: int
                        ) -> List[Tuple[int, int]]:
    """(src, dst) pairs moving stage s's shard i to stage s+1's shard i.

    The last stage wraps to the first (the next microbatch enters as the
    previous one leaves: steady-state pipelining).  STRIPED: the next
    stage's same shard is the ring neighbour d + 1, so every handoff
    (the wrap included) is one hop.  BLOCKED: shard i of stage s sits at
    s * dps + i, so the handoff jumps a whole block (dps hops)."""
    dps = n_devices // n_stages
    shift = 1 if org == StageOrg.STRIPED else dps
    return [(d, (d + shift) % n_devices) for d in range(n_devices)]


def hop_distance(src: int, dst: int, n_devices: int, torus: bool) -> int:
    d = abs(dst - src)
    return min(d, n_devices - d) if torus else d


def placement_cost(org: StageOrg, n_stages: int, n_devices: int,
                   bytes_per_handoff: float, torus: bool = True,
                   link_bw: float = H100_NVLINK_BW_PER_LINK) -> dict:
    """Link cost of one pipeline round: hops, worst-link contention and
    time (``handoff_seconds``: the worst link's bytes over ``link_bw``).

    Every handoff's bytes traverse hop-many links of a 1-D slice of the
    mesh; overlapping paths contend, as in the core NoC model."""
    perm = handoff_permutation(org, n_stages, n_devices)
    link_load = np.zeros(n_devices)      # link i: device i -> i+1 (ring)
    total_hop_bytes = 0.0
    max_hops = 0
    per_dev = bytes_per_handoff / max(1, n_devices // n_stages)
    for src, dst in perm:
        d = hop_distance(src, dst, n_devices, torus)
        max_hops = max(max_hops, d)
        total_hop_bytes += per_dev * d
        step = 1 if ((dst - src) % n_devices) <= n_devices // 2 else -1
        if not torus:
            step = 1 if dst > src else -1
        i = src
        while i != dst:
            link = i if step == 1 else (i - 1) % n_devices
            link_load[link] += per_dev
            i = (i + step) % n_devices
    worst = float(link_load.max()) if len(perm) else 0.0
    return {
        "org": org.value,
        "max_hops": max_hops,
        "total_hop_bytes": total_hop_bytes,
        "worst_link_bytes": worst,
        "handoff_seconds": worst / link_bw,
    }


def choose_placement(n_stages: int, n_devices: int,
                     bytes_per_handoff: float,
                     tp_bytes_per_stage: float,
                     torus: bool = True) -> StageOrg:
    """Sec. IV-B at pod scale: fine interleaving wins when the
    inter-stage (pipelining) traffic dominates the intra-stage (TP)
    traffic; blocked wins when TP collectives dominate."""
    if tp_bytes_per_stage > bytes_per_handoff:
        return StageOrg.BLOCKED
    blocked = placement_cost(StageOrg.BLOCKED, n_stages, n_devices,
                             bytes_per_handoff, torus)
    striped = placement_cost(StageOrg.STRIPED, n_stages, n_devices,
                             bytes_per_handoff, torus)
    return (StageOrg.STRIPED
            if striped["worst_link_bytes"] < blocked["worst_link_bytes"]
            else StageOrg.BLOCKED)


# ---------------------------------------------------------------------------
# the SPMD pipeline program
# ---------------------------------------------------------------------------

def pipeline_spmd_fn(stage_fn: Callable, org: StageOrg, n_stages: int,
                     mesh, n_microbatches: int) -> Callable:
    """A GPipe forward over the mesh's "model" dim:
    ``run(params_stacked, xs) -> ys``.

    ``params_stacked``: a tree of (n_stages, ...) tensors, the same on
    every rank; ``xs``: (n_microbatches, B, ...) on every rank of a
    "model" group (each data shard its own rows).  Each rank applies
    ``stage_fn(params of its stage, x)`` to what it holds, then hands the
    result to ``handoff_permutation``'s destination by point-to-point
    sends over the model group (``dist.batch_isend_irecv``), while
    stage-0 ranks take in the next microbatch.  ``n_microbatches`` steps
    stream the inputs in and ``n_stages - 1`` more drain the pipeline.
    Returns ys (n_microbatches, B, ...) on every rank, ys[k] =
    stage_{S-1}(... stage_0(xs[k])), sent from the last stage's first
    device.  (The reference's shard_map returns xs itself: its result is
    read off a stage-0 device and its scan does not drain; see
    ``ROADMAP.md`` Queue 3.)"""
    names = list(mesh.mesh_dim_names)
    n_dev = mesh.size(names.index("model"))
    if n_dev % n_stages:
        raise ValueError(f"{n_stages} stages do not divide the model "
                         f"axis ({n_dev} devices)")
    perm = handoff_permutation(org, n_stages, n_dev)
    stages = stage_of_device(org, n_stages, n_dev)
    group = mesh.get_group("model") if n_stages > 1 else None
    me = mesh.get_local_rank("model")
    my_stage = stages[me]
    dst = dict(perm)[me]
    src = next(s for s, d in perm if d == me)
    last = stages.index(n_stages - 1)

    def global_rank(i: int) -> int:
        return dist.get_global_rank(group, i)

    def run(params_stacked: Any, xs: torch.Tensor) -> torch.Tensor:
        my_params = tree_map(lambda a: a[my_stage], params_stacked)
        ys = torch.zeros_like(xs)
        buf = torch.zeros_like(xs[0])
        for t in range(n_microbatches + n_stages - 1):
            if my_stage == 0:
                buf = (xs[t] if t < n_microbatches
                       else torch.zeros_like(xs[0]))
            y = stage_fn(my_params, buf).to(xs.dtype).contiguous()
            k = t - (n_stages - 1)
            if my_stage == n_stages - 1 and 0 <= k < n_microbatches:
                ys[k] = y
            if n_stages == 1:         # every device is stage 0: no handoff
                continue
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y, global_rank(dst), group),
                dist.P2POp(dist.irecv, recv, global_rank(src), group)])
            for r in reqs:
                r.wait()
            buf = recv
        if n_stages > 1:
            dist.broadcast(ys, global_rank(last), group=group)
        return ys

    return run
