"""Rank-side programs of the port's multi-rank CPU tests.

``spawn(fn, world, tmp_path, *args)`` (or ``start`` then ``join``)
starts ``world`` processes, each a
gloo rank of one group on a ``FileStore`` under ``tmp_path`` (no fixed
port, so parallel test workers do not collide), runs ``fn(rank, world,
out_dir, *args)`` in each and joins them.  The group has a timeout of
its own and the join a deadline, so a hang fails the test rather than
the suite.  The programs write what the tests compare to files under
``out_dir``; they import torch and the port, never JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import logging
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds a collective waits for its peers
GROUP_TIMEOUT = 120


def _entry(rank, fn, world, store, out_dir, args):
    torch.set_num_threads(1)
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        fn(rank, world, out_dir, *args)
    finally:
        dist.destroy_process_group()


def start(fn, world: int, tmp_path, *args):
    """Start ``fn`` on ``world`` gloo ranks; ``join`` waits for them."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store_{fn.__name__}_{world}_{time.monotonic_ns()}"
    ctx = mp.start_processes(_entry, args=(fn, world, str(store), str(tmp),
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    ctx.deadline_from = time.monotonic()
    return ctx


def join(ctx, name: str, timeout: float = 300.0) -> None:
    """Wait for the ranks ``start`` began; raise if one fails or they
    outlive ``timeout`` seconds from their start."""
    deadline = ctx.deadline_from + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{name} did not end within {timeout} s")


def spawn(fn, world: int, tmp_path, *args, timeout: float = 300.0) -> None:
    """Run ``fn`` on ``world`` gloo ranks; raise if one fails or the
    group outlives ``timeout`` seconds."""
    join(start(fn, world, tmp_path, *args), fn.__name__, timeout)


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# the stage pipeline
# ---------------------------------------------------------------------------

def pipeline_cases(rank, world, out_dir, cases):
    """``pipeline_spmd_fn`` on a (1, world) mesh for each (org, stages):
    stage_fn tanh(x @ w) on seeded weights; rank 0 saves every result."""
    from repro_torch.distributed.pipeline import StageOrg, pipeline_spmd_fn
    mesh = _mesh((1, world))
    out = {}
    for org, n_stages, M, B, D in cases:
        rng = np.random.RandomState(n_stages)
        w = torch.from_numpy((rng.randn(n_stages, D, D).astype(np.float32)
                              / np.sqrt(D)).astype(np.float32))
        xs = torch.from_numpy(rng.randn(M, B, D).astype(np.float32))
        run = pipeline_spmd_fn(lambda p, x: torch.tanh(x @ p["w"]),
                               StageOrg(org), n_stages, mesh, M)
        out[(org, n_stages)] = run({"w": w}, xs)
    if rank == 0:
        torch.save(out, Path(out_dir) / "pipeline.pt")


# ---------------------------------------------------------------------------
# train steps on meshes
# ---------------------------------------------------------------------------

def _full(tree):
    from repro_torch.distributed.hints import to_plain
    from repro_torch.tree import tree_map
    return tree_map(lambda t: to_plain(t).clone(), tree)


def train_cases(rank, world, out_dir, cases):
    """One float32 train step for each (name, arch, mesh shape, M) from the
    parameters and batch saved under ``out_dir`` as ``<arch>.pt``: rank 0
    saves the full updated parameters, moments and metrics, the
    collectives the step issued, and the local shapes of a TP
    projection's output, of an MoE layer's expert buffers and of an rwkv
    time mix's receptance as its per-head region sees them."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.distributed.hints import use_mesh
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  distribute,
                                                  params_shardings)
    from repro_torch.models import layers, rwkv6
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.runtime.steps import make_train_step
    results = {}
    for name, arch, shape, M, opt in cases:
        data = torch.load(Path(out_dir) / f"{arch}.pt")
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32)
        mesh = _mesh(shape)
        params = distribute(data["params"], params_shardings(
            cfg, data["params"], mesh))
        batch = distribute(data["batch"], batch_shardings(
            cfg, data["batch"], mesh))
        local_q, local_xe, local_r = [], [], []
        orig = layers._heads, layers._moe_products, rwkv6._time_mix_heads

        def spy(t, n, hd, tp):
            out = orig[0](t, n, hd, tp)
            if isinstance(out, DTensor):
                local_q.append(tuple(out.to_local().shape))
            return out

        def spy_moe(xe, *w):
            local_xe.append(tuple(xe.shape))
            return orig[1](xe, *w)

        def spy_rwkv(r, *args, **kwargs):
            local_r.append(tuple(r.shape))
            return orig[2](r, *args, **kwargs)
        layers._heads, layers._moe_products = spy, spy_moe
        rwkv6._time_mix_heads = spy_rwkv
        comm = CommDebugMode()
        try:
            with use_mesh(mesh), comm:
                params, state, met = make_train_step(
                    cfg, AdamWConfig(**opt), microbatches=M)(
                        params, init_state(params), batch)
        finally:
            layers._heads, layers._moe_products = orig[:2]
            rwkv6._time_mix_heads = orig[2]
        results[name] = {
            "params": _full(params), "mu": _full(state.mu),
            "nu": _full(state.nu), "step": int(state.step),
            "metrics": {k: float(v) for k, v in met.items()},
            "comm": {str(k).split(".")[-1]: int(v)
                     for k, v in comm.get_comm_counts().items()},
            "local_q": local_q[:1], "local_xe": local_xe[:1],
            "local_r": local_r[:1]}
    if rank == 0:
        torch.save(results, Path(out_dir) / f"train_{world}.pt")


def split_without_gather(rank, world, out_dir, shape, B, M):
    """``steps.microbatch`` on a batch sharded over the data axis issues
    no collective, and microbatch i holds global rows i, i + M, ..."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import NamedSharding, from_full
    from repro_torch.runtime.steps import microbatch
    mesh = _mesh(shape)
    rows = torch.arange(B * 3).reshape(B, 3)
    batch = {"tokens": from_full(rows, NamedSharding(mesh, ("data", None)))}
    comm = CommDebugMode()
    with comm:
        parts = [microbatch(batch, i, M) for i in range(M)]
    out = {"comm": comm.get_total_counts(),
           "placements": [str(p["tokens"].placements) for p in parts],
           "full": [p["tokens"].full_tensor() for p in parts]}
    if rank == 0:
        torch.save(out, Path(out_dir) / "split.pt")


def batch_tiles(rank, world, out_dir, B, S):
    """``device_batches`` on a (pod 2, data 2) mesh: each rank saves the
    rows it holds and its coordinate."""
    from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                           device_batches)
    mesh = _mesh((2, 2), ("pod", "data"))
    ds = TokenDataset(DataConfig(seq_len=S, global_batch=B, vocab=97))
    batch = next(device_batches(ds, mesh=mesh, start_step=1))
    torch.save({"coord": mesh.get_coordinate(),
                "tokens": batch["tokens"].to_local(),
                "placements": str(batch["tokens"].placements),
                "full": batch["tokens"].full_tensor()},
               Path(out_dir) / f"tiles_{rank}.pt")


# ---------------------------------------------------------------------------
# the loop: fault with re-mesh, checkpoints across meshes
# ---------------------------------------------------------------------------

def _loop_setup(ckpt_dir, steps, ckpt_every=2):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import opt_config
    from repro_torch.runtime.train_loop import TrainLoopConfig
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              n_layers=1, dtype=torch.float32)
    loop = TrainLoopConfig(steps=steps, ckpt_every=ckpt_every,
                           ckpt_dir=ckpt_dir, log_every=1, microbatches=2)
    data = DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab)
    return cfg, opt_config(steps, 3e-3), loop, data


def loop_runs(rank, world, out_dir):
    """On 2 ranks: (a) 4 steps on (2, 1), checkpoints at 2 and 4; (b) the
    same with a fault at step 3 whose re-mesh is (2, 1) again; (c) a fault
    at step 3 re-meshed onto (1, 2); (d) (a)'s step-2 checkpoint restored
    onto (1, 2) (DTensor targets) and onto (2, 1) (plain targets with
    ``shardings=``), then resumed to 4 on (1, 2).  Rank 0 saves each
    run's final state in full."""
    from repro_torch.checkpoint.store import restore
    from repro_torch.runtime.train_loop import FaultInjector, train
    out = Path(out_dir)
    res = {}

    def run(tag, meshes, fault=None, steps=4):
        calls = iter(meshes)
        cfg, opt, loop, data = _loop_setup(str(out / tag), steps)
        r = train(cfg, opt, loop, data, fault=fault, device="cpu",
                  mesh_fn=lambda: _mesh(next(calls)))
        res[tag] = {"params": _full(r["params"]), "mu": _full(
            r["opt_state"].mu), "failures": r["failures"],
            "losses": [h["loss"] for h in r["history"]]}
        return r

    a = run("a", [(2, 1)])
    run("b", [(2, 1), (2, 1)], FaultInjector(fail_at=3))
    run("c", [(2, 1), (1, 2)], FaultInjector(fail_at=3))
    from repro_torch.distributed.sharding import distribute, \
        params_shardings
    cfg = _loop_setup(None, 4)[0]
    state = type(a["opt_state"])
    for shape in ((1, 2), (2, 1)):
        mesh = _mesh(shape)
        sh = params_shardings(cfg, a["params"], mesh)
        if shape == (1, 2):      # onto DTensor targets of the new mesh
            back = restore(out / "a", 2, {
                "params": distribute(a["params"], sh),
                "opt": state(step=a["opt_state"].step,
                             mu=distribute(a["opt_state"].mu, sh),
                             nu=distribute(a["opt_state"].nu, sh))})
        else:                    # plain targets and ``shardings=``
            back = restore(
                out / "a", 2,
                {"params": _full(a["params"]),
                 "opt": state(step=a["opt_state"].step,
                              mu=_full(a["opt_state"].mu),
                              nu=_full(a["opt_state"].nu))},
                shardings={"params": sh,
                           "opt": state(step=None, mu=sh, nu=sh)})
        res[f"restored_{shape[0]}x{shape[1]}"] = {
            "params": _full(back["params"]), "mu": _full(back["opt"].mu),
            "placements": [str(p.placements) for p in
                           back["params"]["layers"]["mlp"].values()]}
    # resume (a)'s step-2 checkpoint to 4 on (1, 2)
    import shutil
    if rank == 0:
        shutil.copytree(out / "a", out / "d")
        shutil.rmtree(out / "d" / "step_00000004")
    dist.barrier()
    run("d", [(1, 2)])
    if rank == 0:
        torch.save(res, out / "loop.pt")


# ---------------------------------------------------------------------------
# the kernel wrappers on DTensors
# ---------------------------------------------------------------------------

def wrapper_cases(rank, world, out_dir):
    """Each CUDA wrapper given DTensors on a (1, world) mesh (on the CPU:
    its plain version on each rank's shards, the same routing as on the
    card): ``fused_mlp`` with F over the model axis (the output a sum of
    the ranks' parts), ``attention_op`` with heads over it, ``wkv6`` and
    ``rglru_chunked``; rank 0 saves the full outputs and the inputs."""
    from repro_torch.distributed.hints import hint_any, to_plain, use_mesh
    from repro_torch.distributed.sharding import NamedSharding, from_full
    from repro_torch.kernels.flash_attention import attention_op
    from repro_torch.kernels.fused_mlp import fused_mlp
    from repro_torch.kernels.rglru_scan import rglru_chunked
    from repro_torch.kernels.rwkv6_scan import wkv6
    mesh = _mesh((1, world))
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def on(t, *spec):
        return from_full(t, NamedSharding(mesh, spec))

    x, wg, wu, wd = rnd(6, 16), rnd(16, 32), rnd(16, 32), rnd(32, 16)
    q, k, v = rnd(2, 8, 4, 16), rnd(2, 8, 2, 16), rnd(2, 8, 2, 16)
    r, kk, vv = rnd(4, 8, 16), rnd(4, 8, 16), rnd(4, 8, 16)
    w, u = torch.sigmoid(rnd(4, 8, 16)), rnd(4, 1, 16)
    a, b = torch.sigmoid(rnd(2, 8, 8)), rnd(2, 8, 8)
    with use_mesh(mesh):
        out = {
            "fused_mlp": fused_mlp(on(x, None, None), on(wg, "data", "model"),
                                   on(wu, "data", "model"),
                                   on(wd, "model", "data")),
            "attention_op": attention_op(on(q, None, None, "model", None),
                                         on(k, None, None, "model", None),
                                         on(v, None, None, "model", None),
                                         causal=True),
            "wkv6": wkv6(on(r, None, None, None), on(kk, None, None, None),
                         on(vv, None, None, None), on(w, None, None, None),
                         on(u, None, None, None)),
            "rglru_chunked": rglru_chunked(on(a, None, None, "model"),
                                           on(b, None, None, "model")),
        }
        # the first spec whose dims divide: 3 rows do not split in 2
        out["hint_any"] = hint_any(on(rnd(2, 3, 4), None, None, None),
                                   [("batch", "model", None),
                                    ("batch", None, "model")])
    placements = {name: [str(t.placements) for t in
                         (o if isinstance(o, tuple) else (o,))]
                  for name, o in out.items()}
    full = {name: tuple(to_plain(t) for t in
                        (o if isinstance(o, tuple) else (o,)))
            for name, o in out.items()}
    if rank == 0:
        torch.save({"full": full, "placements": placements,
                    "inputs": (x, wg, wu, wd, q, k, v, r, kk, vv, w, u, a,
                               b)}, Path(out_dir) / "wrappers.pt")


# ---------------------------------------------------------------------------
# attention's layouts
# ---------------------------------------------------------------------------

def attention_cases(rank, world, out_dir, cases):
    """``layers.attention`` (and ``_sdpa_chunked``) in float32 on a (1,
    world) mesh for each case ``(name, H, Hkv, kind)``: ``train`` a
    forward of (2, 8) with the gradients of the parameters and of x,
    ``kernels`` the same forward under ``use_kernels`` (on the CPU the
    flash wrapper's plain version), ``chunked`` ``_sdpa_chunked`` of
    (2, 32) at chunk 8 and window 12 with q's gradient, ``decode`` one
    token into a cache split over its sequence.  Rank 0 saves the
    full results, the inputs and each result's placements."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.hints import to_plain, use_mesh
    from repro_torch.distributed.sharding import NamedSharding, from_full
    from repro_torch.models import layers
    mesh = _mesh((1, world))
    results = {}
    for name, H, Hkv, kind in cases:
        cfg = dataclasses.replace(
            get_config("qwen2.5-3b", smoke=True), n_heads=H,
            n_kv_heads=Hkv, head_dim=8, d_model=32, dtype=torch.float32,
            use_kernels=kind == "kernels")
        g = torch.Generator().manual_seed(5)
        p = layers.init_attention(g, cfg)
        p = {k: v + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in p.items()}
        S = 32 if kind == "chunked" else 8
        x = torch.randn((2, S, 32), generator=g)

        def on(t, *spec, grad=True):
            return from_full(t, NamedSharding(mesh, spec)).requires_grad_(
                grad)

        dp = {k: on(v, *((None, "model") if k in ("wq", "wk", "wv")
                         else ("model", None) if k == "wo" else (None,)))
              for k, v in p.items()}
        dx = on(x, None, None, None)
        pos = torch.arange(S)
        with use_mesh(mesh):
            if kind == "chunked":
                q = on(torch.randn((2, S, H, 8), generator=g),
                       None, None, "model" if H % world == 0 else None,
                       None)
                k, v = (on(torch.randn((2, S, Hkv, 8), generator=g),
                           None, None, None, None) for _ in range(2))
                out = layers._sdpa_chunked(q, k, v, cfg, 12, chunk=8)
                out.sum().backward()
                grads = {"q": q.grad}
                inputs = {"q": q, "k": k, "v": v}
            elif kind == "decode":
                T = 2 * world * 4
                ck, cv = (on(torch.randn((2, T, Hkv, 8), generator=g),
                             None, "model", None, None, grad=False)
                          for _ in range(2))
                x1 = on(x[:, :1], None, None, None, grad=False)
                with torch.no_grad():
                    out = layers.attention(dp, x1, cfg,
                                           torch.full((2, 1), 5),
                                           cache=(ck, cv), cache_index=5)
                grads = {}
                inputs = {"x": x1, "ck": ck, "cv": cv}
            else:
                out = layers.attention(dp, dx, cfg, pos)
                out.pow(2).sum().backward()
                grads = {k: v.grad for k, v in dp.items()}
                grads["x"] = dx.grad
                inputs = {"x": dx}
        results[name] = {
            "out": to_plain(out.detach()),
            "grads": {k: to_plain(v) for k, v in grads.items()},
            "inputs": {k: to_plain(v.detach()) for k, v in inputs.items()},
            "params": p, "placements": str(out.placements)}
    if rank == 0:
        torch.save(results, Path(out_dir) / "attention.pt")


def decode_dispatch(rank, world, out_dir, H, Hkv):
    """One token of ``layers.attention`` in float32 under ``use_kernels``
    on a (1, world) mesh, into a cache split over its sequence, with
    ``layers.decode_attention_op`` and ``layers._sdpa`` counting their
    calls.  Rank 0 saves the full output, the inputs, the parameters and
    the counts."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.hints import to_plain, use_mesh
    from repro_torch.distributed.sharding import NamedSharding, from_full
    from repro_torch.models import layers
    mesh = _mesh((1, world))
    calls = {"decode_attention_op": 0, "_sdpa": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    layers.decode_attention_op = counted("decode_attention_op",
                                         layers.decode_attention_op)
    layers._sdpa = counted("_sdpa", layers._sdpa)
    cfg = dataclasses.replace(
        get_config("qwen2.5-3b", smoke=True), n_heads=H, n_kv_heads=Hkv,
        head_dim=8, d_model=32, dtype=torch.float32, use_kernels=True)
    g = torch.Generator().manual_seed(5)
    p = layers.init_attention(g, cfg)
    p = {k: v + 0.01 * torch.randn(v.shape, generator=g)
         for k, v in p.items()}
    T = 2 * world * 4
    x = torch.randn((2, 1, 32), generator=g)
    ck, cv = (torch.randn((2, T, Hkv, 8), generator=g) for _ in range(2))

    def on(t, *spec):
        return from_full(t, NamedSharding(mesh, spec))

    dp = {k: on(v, *((None, "model") if k in ("wq", "wk", "wv")
                     else ("model", None) if k == "wo" else (None,)))
          for k, v in p.items()}
    inputs = {"x": x, "ck": ck.clone(), "cv": cv.clone()}
    with use_mesh(mesh), torch.no_grad():
        out = layers.attention(
            dp, on(x, None, None, None), cfg, torch.full((2, 1), 5),
            cache=(on(ck, None, "model", None, None),
                   on(cv, None, "model", None, None)), cache_index=5)
    full = to_plain(out)
    if rank == 0:
        torch.save({"out": full, "inputs": inputs, "params": p,
                    "calls": calls}, Path(out_dir) / "decode_dispatch.pt")


# ---------------------------------------------------------------------------
# decode on meshes
# ---------------------------------------------------------------------------

def decode_cases(rank, world, out_dir, cases, B, T, n_steps):
    """For each ``(name, arch, mesh shape, n_kv_heads)``: the float32 smoke
    config's seeded parameters and a zero cache, both on their
    shardings (``params_shardings``, ``cache_shardings``), ``n_steps``
    ``decode_step`` calls from index 0 with seeded tokens, then one
    ``make_serve_step`` call, then ``zero_cache_slot`` of the last batch
    slot.  Rank 0 saves each step's full logits, the served tokens, the
    full cache before and after the slot's wipe and the cache's
    placements."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.hints import use_mesh
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  distribute,
                                                  params_shardings)
    from repro_torch.models import (decode_step, init_cache, init_model,
                                    zero_cache_slot)
    from repro_torch.runtime.steps import make_serve_step
    from repro_torch.tree import leaves
    results = {}
    for name, arch, shape, kv in cases:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype=torch.float32)
        if kv:
            cfg = dataclasses.replace(cfg, n_kv_heads=kv)
        mesh = _mesh(shape)
        params = init_model(cfg, seed=0, device="cpu")
        params = distribute(params, params_shardings(cfg, params, mesh))
        cache = init_cache(cfg, B, T, device="cpu")
        cache = distribute(cache, cache_shardings(cfg, cache, mesh))
        toks = torch.from_numpy(np.random.RandomState(7).randint(
            0, cfg.vocab, (n_steps + 1, B, 1)))
        logits = []
        with use_mesh(mesh):
            for i in range(n_steps):
                out, cache = decode_step(params, cfg, toks[i], cache, i)
                logits.append(out.full_tensor())
            served, cache = make_serve_step(cfg)(params, toks[n_steps],
                                                 cache, n_steps)
            full = _full(cache)
            zero_cache_slot(cfg, cache, B - 1)
        results[name] = {
            "logits": logits, "served": served.full_tensor(),
            "cache": full, "zeroed": _full(cache),
            "placements": [str(t.placements) for t in leaves(cache)]}
    if rank == 0:
        torch.save(results, Path(out_dir) / "decode.pt")
