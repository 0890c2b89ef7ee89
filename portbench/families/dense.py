"""The dense decoder family (``"family": "dense"`` in a configuration's
file): grouped-query attention, RMSNorm, RoPE, a SwiGLU MLP, optional
QKV biases, a tied or untied head.

What a family gives the harness: ``spec`` (the shapes, from the
configuration's published values), ``draw`` (the benchmark's weights,
on the device from the seed), ``port_config`` and ``port_params`` (the
program's configuration and parameter tree over those same weights) and
``served_gaps`` (the plain reference's reading of served tokens), and
``decode_token_flops`` (a token's model FLOPs at a context, from
``flops.py``).

Weights (L layers stacked on the leading dim; ``Vp`` embedding rows, the
published vocab padded as the program pads it):

    embed (Vp, D), unembed (D, Vp) unless tied, norm_f (D,);
    norm1, norm2 (L, D); wq (L, D, H hd), wk, wv (L, D, Hkv hd),
    wo (L, H hd, D), bq (L, H hd), bk, bv (L, Hkv hd) with biases;
    w_gate, w_up (L, D, F), w_down (L, F, D).

Matrices and biases are bf16, normal with fan-in scaling; the norms'
gain offsets are float32, normal with deviation 0.1.  The program and
the reference read these same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from portbench.flops import decode_token_flops  # noqa: F401
from portbench.reference.decoder import served_gaps  # noqa: F401
from portbench.reference.decoder import spec_from_config as spec  # noqa: F401


def port_config(conf: Dict):
    """The program's named configuration (``port_config``) with every
    field the published configuration fixes set from it, as run: bf16,
    the kernels on."""
    from repro_torch.configs import get_config
    p, d = conf["published"], conf["derived"]
    if d["dtype"] != "bfloat16":
        raise ValueError(f"{conf['name']}: the cells serve bf16 weights")
    return dataclasses.replace(
        get_config(conf["port_config"]), name=conf["name"],
        arch_kind="dense", n_layers=p["num_hidden_layers"],
        d_model=p["hidden_size"], n_heads=p["num_attention_heads"],
        n_kv_heads=p["num_key_value_heads"], d_ff=p["intermediate_size"],
        vocab=p["vocab_size"], head_dim=d["head_dim"],
        qkv_bias=d["qkv_bias"], rope_theta=float(p["rope_theta"]),
        norm_eps=float(p["rms_norm_eps"]),
        tie_embeddings=p["tie_word_embeddings"], dtype=torch.bfloat16,
        local_window=0, n_experts=0, kv_quant=False, use_kernels=True)


def port_params(w: Dict[str, torch.Tensor]) -> Dict:
    """The benchmark's weights as the program's parameter tree (views,
    no copies)."""
    attn = {k: w[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if k in w}
    params = {"embed": w["embed"], "ln_f": w["norm_f"],
              "layers": {"ln1": w["norm1"], "ln2": w["norm2"], "attn": attn,
                         "mlp": {k: w[k]
                                 for k in ("w_gate", "w_up", "w_down")}}}
    if "unembed" in w:
        params["unembed"] = w["unembed"]
    return params


def draw(spec: Dict, seed: int, device, vocab_rows: int,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The weights, drawn on ``device`` from ``seed``, one call a
    tensor."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    L, D, F = spec["layers"], spec["d_model"], spec["d_ff"]
    qd = spec["heads"] * spec["head_dim"]
    kd = spec["kv_heads"] * spec["head_dim"]

    def normal(shape, std, dt=dtype):
        t = torch.empty(shape, dtype=dt, device=device)
        return t.normal_(0.0, std, generator=gen)

    w = {"embed": normal((vocab_rows, D), 0.02),
         "norm_f": normal((D,), 0.1, torch.float32),
         "norm1": normal((L, D), 0.1, torch.float32),
         "norm2": normal((L, D), 0.1, torch.float32),
         "wq": normal((L, D, qd), D ** -0.5),
         "wk": normal((L, D, kd), D ** -0.5),
         "wv": normal((L, D, kd), D ** -0.5),
         "wo": normal((L, qd, D), qd ** -0.5),
         "w_gate": normal((L, D, F), D ** -0.5),
         "w_up": normal((L, D, F), D ** -0.5),
         "w_down": normal((L, F, D), F ** -0.5)}
    if not spec["tied"]:
        w["unembed"] = normal((D, vocab_rows), D ** -0.5)
    if spec["qkv_bias"]:
        w["bq"] = normal((L, qd), 0.02)
        w["bk"] = normal((L, kd), 0.02)
        w["bv"] = normal((L, kd), 0.02)
    return w
