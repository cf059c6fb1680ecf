"""A plain float32 forward pass of the decoder models the benchmark serves
(dense GQA and moe with shared and routed experts), used to judge the
tokens the engine served.

What it computes for one served request: a causal language model over
the prompt followed by the served tokens, and its logits at every
position that chose a served token (the prompt's last position for the
first, each served token's own position for the next). It knows nothing
of how the engine lays a request out in its cache.

The moe layer follows the configuration's arithmetic: softmax over the
router's logits, top-k, the weights renormalised, each expert's queue
capped at ``min(int(capacity_factor * t * k / E) + 1, t)`` slots over the
t tokens of one call, counted in token order, the slots past it dropped.
The prompt is one call of P tokens, as the exact-length prefill is; each
decoded token is a call of its own (so nothing drops there).

``quant="fp8"`` is the control: every matrix product of the layers and
the unembedding takes both operands rounded to float8 e4m3 with one
scale per tensor (per expert for the stacked experts), as an fp8 GEMM
does, and accumulates in float32. The router, norms, rotary embedding
and the attention's softmax stay in float32.

Weights arrive in the port's tree layout (``blocks`` stacked on a
leading layer axis, projections in ``x @ W`` orientation) in whatever
dtype they are served in; each layer is widened to float32 only while it
runs, so the reference fits beside them on the card.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (per slice along `dims`
    kept, else per tensor), returned in float32."""
    a = x.abs().amax() if dims is None else x.abs().amax(dim=dims,
                                                          keepdim=True)
    scale = torch.clamp(a, min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x, w, quant):
    if quant == "fp8":
        return q8(x) @ q8(w)
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x, theta):
    """Rotary embedding, half-split layout, position = row index.
    x (S, H, hd)."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, gate, up, down, quant):
    return _mm(F.silu(_mm(x, gate, quant)) * _mm(x, up, quant), down, quant)


def capacity(t: int, moe: dict) -> int:
    return min(int(moe["capacity_factor"] * t * moe["top_k"]
                   / moe["num_experts"]) + 1, t)


def moe_layer(x, p, moe: dict, calls: Sequence[slice], quant):
    """x (S, d) f32; `calls` partition the rows into the calls whose
    capacity they share."""
    E, k = moe["num_experts"], moe["top_k"]
    probs = torch.softmax(x @ p["router"], dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    keep = torch.ones_like(top_w, dtype=torch.bool)
    for sl in calls:
        t = sl.stop - sl.start
        cap = capacity(t, moe)
        flat = top_e[sl].reshape(-1)
        onehot = flat[:, None] == torch.arange(E, device=x.device)[None]
        pos = (torch.cumsum(onehot.to(torch.int64), dim=0) - 1)
        pos = pos.gather(1, flat[:, None])[:, 0]
        keep[sl] = (pos < cap).view(t, k)
    w = top_w * keep
    y = torch.zeros_like(x)
    ex = p["experts"]
    for e in range(E):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        h = swiglu(x[rows], ex["gate"][e], ex["up"][e], ex["down"][e], quant)
        y.index_add_(0, rows, h * w[rows, slot][:, None])
    if "shared" in p:
        sh = p["shared"]
        y = y + swiglu(x, sh["gate"], sh["up"], sh["down"], quant)
    return y


def _layer(h, p, model, prompt_len, quant):
    """One block over one request's positions. h (S, d) f32."""
    s = h.shape[0]
    nh, kvh = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // nh
    eps = model["norm_eps"]
    x = rms_norm(h, p["attn_norm_scale"], eps)
    a = p["attn"]
    q, k, v = _mm(x, a["wq"], quant), _mm(x, a["wk"], quant), \
        _mm(x, a["wv"], quant)
    if "bq" in a:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = rope(q.view(s, nh, hd), model["rope_theta"])
    k = rope(k.view(s, kvh, hd), model["rope_theta"])
    v = v.view(s, kvh, hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=h.device).tril()
    g = nh // kvh
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[None], float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)
    h = h + _mm(o.reshape(s, nh * hd), a["wo"], quant)
    x = rms_norm(h, p["mlp_norm_scale"], eps)
    if model.get("moe"):
        calls = [slice(0, prompt_len)] + [slice(i, i + 1)
                                           for i in range(prompt_len, s)]
        return h + moe_layer(x, p["moe"], model["moe"], calls, quant)
    m = p["mlp"]
    return h + swiglu(x, m["gate"], m["up"], m["down"], quant)


def _widen(tree, i: Optional[int] = None):
    if isinstance(tree, dict):
        return {key: _widen(t, i) for key, t in tree.items()}
    return (tree if i is None else tree[i]).float()


def served_gaps(model: dict, params,
                requests: List[Dict], *, quant: Optional[str] = None,
                device="cuda") -> List[Dict[str, np.ndarray]]:
    """For each request {"prompt": ids, "served": ids}: the float32
    reference's logit gap (its best logit less the served token's) at every
    position that chose a served token, and with `quant` the same gap of
    the token the quantized reference puts first there. A request may
    carry "judge": other tokens, one per served token, whose gaps are read
    in place of the served ones' (the context stays the served tokens).

    Returns per request {"served": (n,) gaps} and, with `quant`,
    {"control": (n,) gaps}."""
    _no_tf32()
    with torch.no_grad():
        table = params["embed"]["table"]
        hs, ctl, layouts = [], [], []
        for r in requests:
            prompt = np.asarray(r["prompt"], np.int64)
            served = np.asarray(r["served"], np.int64)
            p = len(prompt)
            seq = np.concatenate([prompt, served[:-1]])
            rows = np.arange(p - 1, len(seq))
            ids = torch.as_tensor(seq, device=device)
            hs.append(table[ids].float())
            if quant:
                ctl.append(hs[-1].clone())
            judge = np.asarray(r.get("judge", served), np.int64)
            layouts.append((p, rows, judge))
        blocks = params["blocks"]
        for i in range(model["num_layers"]):
            lp = _widen(blocks, i)
            for j, (p, _rows, _s) in enumerate(layouts):
                hs[j] = _layer(hs[j], lp, model, p, None)
                if quant:
                    ctl[j] = _layer(ctl[j], lp, model, p, quant)
            del lp
        fn = _widen(params["final_norm"])["scale"]
        if "lm_head" in params:
            w = params["lm_head"]["kernel"].float()
        else:
            w = table.float().t()
        out = []
        for j, (p, rows, served) in enumerate(layouts):
            sel = torch.as_tensor(rows, device=device)
            tgt = torch.as_tensor(served, device=device)
            x = rms_norm(hs[j][sel], fn, model["norm_eps"])
            logits = x @ w
            best = logits.max(dim=-1).values
            rec = {"served": (best - logits.gather(1, tgt[:, None])[:, 0])
                   .cpu().numpy()}
            if quant:
                xc = rms_norm(ctl[j][sel], fn, model["norm_eps"])
                first = _mm(xc, w, quant).argmax(dim=-1)
                rec["control"] = (best - logits.gather(1, first[:, None])
                                  [:, 0]).cpu().numpy()
            out.append(rec)
        return out
