"""Stage-1: finest pipelining granularity from loop orders — Alg. 1 + Sec. III-C.

Granularity = the portion (in elements) of the intermediate tensor produced
per synchronization step between a producer/consumer pair.

Algorithm 1 walks the two loop nests outermost-first over the *shared*
tensor's ranks, fusing while the rank pair matches and tile sizes agree;
it stops at the first mismatch.  The granularity is the product of the
shared tensor's rank extents *below* the fused prefix (with an
LCM(tile_p, tile_c) correction at a tile-size mismatch on a matching rank).

Fig. 4 legality conditions:
  * the producer's contracted rank must not be outermost;
  * the consumer's unshared rank must not be outermost;
  * at least the outermost loop must match.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from .dataflow import Dataflow
from .graph import Op, OpKind


@dataclasses.dataclass(frozen=True)
class Granularity:
    producer: str
    consumer: str
    elements: int                 # elements of the intermediate per interval
    fused_ranks: Tuple[str, ...]  # matched outer-loop prefix
    pipelinable: bool
    reason: str = ""


def _shared_rank_map(producer: Op, consumer: Op) -> Dict[str, str]:
    """consumer-rank -> producer-rank correspondence on the shared tensor.

    The shared tensor is the producer's output.  E.g. CONV->CONV: producer
    output ranks (N,H,W,K) feed the consumer's input ranks (N,H,W,C), so
    consumer C corresponds to producer K.
    """
    p_out = producer.output_ranks()
    if consumer.kind in (OpKind.CONV, OpKind.DWCONV, OpKind.POOL):
        c_in = ("N", "H", "W", "C")
    elif consumer.kind == OpKind.GEMM:
        c_in = ("M", "K")
    else:
        c_in = consumer.output_ranks()
    if len(c_in) != len(p_out):
        # rank mismatch (e.g. conv -> gemm via flatten): match batch only
        return {c_in[0]: p_out[0]}
    return dict(zip(c_in, p_out))


#: consumers that accept data in whatever order it is produced (elementwise
#: joins, pools, upsamples): granularity = the producer's natural emission
#: burst — the innermost output rank of its loop order.
STREAMING_KINDS = frozenset({OpKind.ADD, OpKind.CONCAT, OpKind.POOL,
                             OpKind.UPSAMPLE, OpKind.GLOBALPOOL})


def finest_granularity(producer: Op, pdf: Dataflow,
                       consumer: Op, cdf: Dataflow) -> Granularity:
    p_out = producer.output_ranks()

    if consumer.kind in STREAMING_KINDS:
        out_in_order = [r for r in pdf.loop_order if r in p_out]
        if len(out_in_order) <= 1:
            elems = producer.output_volume()
        else:
            elems = producer.dims.get(out_in_order[-1], 1)
        return Granularity(producer.name, consumer.name, max(1, elems),
                           tuple(out_in_order[:-1]), True, "streaming consumer")

    if producer.kind in STREAMING_KINDS:
        # order-flexible producer (concat/add/pool): it emits in whatever
        # order the consumer wants, so the granularity is the consumer's
        # tiled consumption chunk of the shared tensor.
        cmap = _shared_rank_map(producer, consumer)
        chunk = 1
        for rc in cmap:
            chunk *= max(1, cdf.tile(rc))
        chunk = min(chunk, producer.output_volume())
        return Granularity(producer.name, consumer.name, max(1, chunk),
                           tuple(cmap.values()), True, "streaming producer")

    cmap = _shared_rank_map(producer, consumer)   # consumer rank -> producer rank
    shared_c = set(cmap)
    shared_p = set(cmap.values())

    # ---- Fig. 4 legality ----------------------------------------------------
    if pdf.loop_order and pdf.loop_order[0] in producer.contracted_ranks():
        return Granularity(producer.name, consumer.name,
                           producer.output_volume(), (), False,
                           "producer contracted rank outermost")
    c_unshared_out = [r for r in cdf.loop_order if r not in shared_c
                      and r not in consumer.contracted_ranks()]
    if cdf.loop_order and cdf.loop_order[0] in c_unshared_out:
        return Granularity(producer.name, consumer.name,
                           producer.output_volume(), (), False,
                           "consumer unshared rank outermost")

    # ---- Alg. 1: match outer loops ------------------------------------------
    fused: list[str] = []
    lcm_penalty = 1
    for lp, lc in zip(pdf.loop_order, cdf.loop_order):
        if lp not in shared_p or lc not in shared_c:
            break
        if cmap[lc] != lp:
            break
        tp, tc = pdf.tile(lp), cdf.tile(lc)
        if tp != tc:
            # Sec. III-C: sync every LCM(tile_p, tile_c) of this rank
            lcm_penalty = math.lcm(max(1, tp), max(1, tc)) // max(
                1, min(tp, tc))
            fused.append(lp)
            break
        fused.append(lp)

    if not fused:
        return Granularity(producer.name, consumer.name,
                           producer.output_volume(), (), False,
                           "outermost loops do not match")

    d = producer.dims
    elems = 1
    for r in p_out:
        if r not in fused:
            elems *= d.get(r, 1)
    elems *= lcm_penalty
    elems = min(elems, producer.output_volume())
    return Granularity(producer.name, consumer.name, max(1, elems),
                       tuple(fused), True)


def segment_granularities(ops, dataflows) -> list:
    """Granularity for each adjacent producer/consumer pair in a segment."""
    out = []
    for i in range(len(ops) - 1):
        out.append(finest_granularity(ops[i], dataflows[i],
                                      ops[i + 1], dataflows[i + 1]))
    return out
