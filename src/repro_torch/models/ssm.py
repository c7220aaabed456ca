"""Recurrent mixers: Mamba (selective SSM) and xLSTM (mLSTM / sLSTM).

The counterpart of the JAX package's ``models/ssm.py``. The Mamba scan is
chunked as the reference's is: a loop over sequence chunks carrying the
(B, d_inner, d_state) state, with a log-depth inclusive scan inside each
chunk, so only one chunk's (B, Q, d_inner, d_state) tensor is ever
materialized. The reference's ``associative_scan`` pairs the terms in
another tree, so the two sum in other orders (float32 rounding, no more).

mLSTM keeps its exact recurrence (exponential gating with the max-stabilizer
from the xLSTM paper) under a time-step loop whose carry is the matrix
memory (B, H, dh, dh); q/k/v/gate projections are hoisted out of the loop
so the sequential part is only the rank-1 state update. sLSTM is inherently
sequential (h_{t-1} feeds the gates) — a time-step loop is the
architecture, not an implementation shortcut.

Decode paths update the same states one token at a time — O(1) in
context. Each returns the new state; the model copies it into its caches
in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import scan_config
from repro_torch.models.layers import (dense_init, draw_device, dtype_of,
                                       normal_init, rms_norm, silu,
                                       uniform_init)
from repro_torch.sharding import activations as act


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def init_mamba(cfg: ArchConfig, generator: torch.Generator) -> dict:
    D, di, ds, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    dtr = cfg.resolved_dt_rank
    dt = dtype_of(cfg.param_dtype)
    dev = draw_device(generator)
    in_proj = dense_init(generator, D, 2 * di, dt)
    conv_w = normal_init(generator, (dc, di), 1.0, torch.float32)
    x_proj = dense_init(generator, di, dtr + 2 * ds, dt)
    dt_proj = dense_init(generator, dtr, di, dt)
    u = uniform_init(generator, (di,), math.log(1e-3), math.log(1e-1))
    out_proj = dense_init(generator, di, D, dt)
    # S4-style A init: A_log = log(1..ds) per channel.
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w / math.sqrt(dc)).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": torch.log(torch.expm1(torch.clamp_min(
            torch.exp(u), 1e-4))).to(dt),
        "A_log": torch.log(a)[None, :].expand(di, ds).contiguous(),
        "D_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": out_proj,
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B, S, di), w (dc, di)."""
    dc = w.shape[0]
    if act.old_dtensor_on_mesh(x):
        # torch before 2.13: no redistribution plan for the pad of a
        # channel-sharded x, and a tap's (1, 1, di) view of a multi-axis
        # shard takes the local length: the zero rows placed as x is and
        # joined on the unsharded sequence dim, the taps gathered whole
        zeros = torch.zeros((x.shape[0], dc - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
        pad = torch.cat([act.like("aten::constant_pad_nd (causal conv)",
                                  zeros, x), x], dim=1)
        w = act.replicated("aten::view (causal conv taps)", w)
    else:
        pad = F.pad(x, (0, 0, dc - 1, 0))
    # the taps as (1, 1, di): a mesh places them as it does x's channels
    out = sum(pad[:, j:j + x.shape[1]] * w[j].view(1, 1, -1)
              for j in range(dc))
    return out + b.view(1, 1, -1)


def _ssm_scan_chunk(a, b, h0):
    """One chunk of the diagonal SSM recurrence h_t = a_t h_{t-1} + b_t.

    a, b: (B, Q, di, ds); h0 (B, di, ds). An inclusive log-depth scan
    (Hillis–Steele) of the pairs (a, b) under (a1, b1)·(a2, b2) = (a2 a1,
    a2 b1 + b2) for the homogeneous part, then the carry-in through the
    cumulative decay (a ∈ (0,1] so the product never overflows). Returns
    (h_all, h_last).
    """
    Q = a.shape[1]
    step = 1
    while step < Q:
        b = torch.cat([b[:, :step],
                       a[:, step:] * b[:, :-step] + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], dim=1)
        step *= 2
    h_all = b + a * h0[:, None]
    return h_all, h_all[:, -1]


def mamba_train(p: dict, cfg: ArchConfig, x: torch.Tensor,
                chunk: int = 256) -> torch.Tensor:
    """Full-sequence Mamba mixer. x (B, S, D) → (B, S, D)."""
    y, _ = _mamba_forward(p, cfg, x, chunk, return_state=False)
    return y


def mamba_prefill(p: dict, cfg: ArchConfig, x: torch.Tensor,
                  chunk: int = 256) -> tuple[torch.Tensor, dict]:
    """Full-sequence Mamba that also returns the decode state."""
    return _mamba_forward(p, cfg, x, chunk, return_state=True)


def _mamba_forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
                   chunk: int = 256, return_state: bool = False):
    B, S, D = x.shape
    di, ds = cfg.d_inner, cfg.d_state
    dtr = cfg.resolved_dt_rank
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")

    xz = act.ffn_hidden(x @ p["in_proj"])
    xp, z = xz.chunk(2, dim=-1)                             # (B,S,di) each
    xc = silu(_causal_conv(xp, p["conv_w"], p["conv_b"]))
    proj = xc @ p["x_proj"]                                 # (B,S,dtr+2ds)
    dt_r = proj[..., :dtr]
    Bm = proj[..., dtr:dtr + ds].float()                    # (B,S,ds)
    Cm = proj[..., dtr + ds:].float()
    dt = _softplus(act.add("aten::add (dt bias, a shard beside a partial "
                           "sum)", (dt_r @ p["dt_proj"]).float(),
                           p["dt_bias"].float()))           # (B,S,di)
    A = -torch.exp(p["A_log"])                              # (di, ds) fp32
    xcf = xc.float()

    h = act.ssm_state(torch.zeros((B, di, ds), dtype=torch.float32,
                                  device=x.device))
    ys = []
    for c in scan_config.loop("mamba_chunks", S // Q):
        sl = slice(c * Q, (c + 1) * Q)
        dt_c, b_c, c_c, x_c = dt[:, sl], Bm[:, sl], Cm[:, sl], xcf[:, sl]
        a = torch.exp(dt_c[..., None] * A)                  # (B,Q,di,ds)
        binc = (dt_c * x_c)[..., None] * b_c[:, :, None, :]  # (B,Q,di,ds)
        h_all, h = _ssm_scan_chunk(a, binc, h)
        del a, binc
        if act.old_dtensor_on_mesh(h_all) and act.on_mesh(
                "aten::einsum (SSM readout, a product and a sum)"):
            ys.append((h_all * c_c[:, :, None, :]).sum(-1))
        else:
            ys.append(torch.einsum("bqns,bqs->bqn", h_all, c_c))  # (B,Q,di)
        del h_all
    ys = ys * (S // Q // len(ys))
    y = torch.cat(ys, dim=1)                                # (B,S,di)
    y = y + p["D_skip"] * xcf
    y = (y * silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if not return_state:
        return out, None
    dc = cfg.d_conv
    conv_state = xp[:, -(dc - 1):].to(x.dtype) if dc > 1 else \
        torch.zeros((B, 0, di), dtype=x.dtype, device=x.device)
    if S < dc - 1:
        conv_state = torch.cat([torch.zeros((B, dc - 1 - S, di),
                                            dtype=x.dtype, device=x.device),
                                xp.to(x.dtype)], dim=1)
    return out, {"h": h, "conv": conv_state}


def init_mamba_state(cfg: ArchConfig, batch: int, dtype, device=None,
                     lead: tuple = ()) -> dict:
    """Zeroed decode state, with ``lead`` dims in front (the unit axis of
    a stack)."""
    di, ds, dc = cfg.d_inner, cfg.d_state, cfg.d_conv
    return {
        "h": torch.zeros((*lead, batch, di, ds), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, dc - 1, di), dtype=dtype,
                            device=device),
    }


def mamba_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 state: dict) -> tuple[torch.Tensor, dict]:
    """One-token Mamba step. x (B, 1, D)."""
    ds = cfg.d_state
    dtr = cfg.resolved_dt_rank
    xz = x[:, 0] @ p["in_proj"]
    xp, z = xz.chunk(2, dim=-1)                             # (B, di)
    window = torch.cat([state["conv"],
                        xp[:, None].to(state["conv"].dtype)], dim=1)
    xc = torch.einsum("bci,ci->bi", window.float(), p["conv_w"].float()) \
        + p["conv_b"].float()
    xc = silu(xc)
    proj = xc.to(x.dtype) @ p["x_proj"]
    dt_r = proj[..., :dtr]
    Bm = proj[..., dtr:dtr + ds].float()
    Cm = proj[..., dtr + ds:].float()
    dt = _softplus((dt_r @ p["dt_proj"]).float()
                   + p["dt_bias"].float())
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt[..., None] * A)                        # (B,di,ds)
    h = a * state["h"] + (dt * xc)[..., None] * Bm[:, None, :]
    y = torch.einsum("bns,bs->bn", h, Cm) + p["D_skip"] * xc
    y = (y * silu(z.float())).to(x.dtype)
    out = (y @ p["out_proj"])[:, None]
    return out, {"h": h, "conv": window[:, 1:]}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating with stabilizer)
# ---------------------------------------------------------------------------

def _mlstm_inner(cfg: ArchConfig) -> int:
    di = int(cfg.lstm_proj_factor * cfg.d_model)
    return (di // cfg.n_heads) * cfg.n_heads


def init_mlstm(cfg: ArchConfig, generator: torch.Generator) -> dict:
    D = cfg.d_model
    di = _mlstm_inner(cfg)
    H = cfg.n_heads
    dt = dtype_of(cfg.param_dtype)
    dev = draw_device(generator)
    p = {
        "in_proj": dense_init(generator, D, 2 * di, dt),
        "wq": dense_init(generator, di, di, dt),
        "wk": dense_init(generator, di, di, dt),
        "wv": dense_init(generator, di, di, dt),
        "gates_w": dense_init(generator, di, 2 * H, torch.float32),
    }
    p["gates_b"] = torch.cat([
        torch.zeros((H,), dtype=torch.float32, device=dev),   # input gate
        torch.full((H,), 3.0, dtype=torch.float32, device=dev),  # forget
    ])
    p["norm"] = torch.ones((di,), dtype=dt, device=dev)  # per-head norm
    p["out_proj"] = dense_init(generator, di, D, dt)
    return p


def _mlstm_qkvg(p, cfg, x):
    """Hoisted projections. x (B,S,D) → q,k,v (B,S,H,dh), li/lf (B,S,H), z.

    ``k`` is float32: the reference divides it by a numpy float64 scalar,
    which promotes it."""
    di = p["wq"].shape[0]
    H = cfg.n_heads
    dh = di // H
    xz = x @ p["in_proj"]
    xm, z = xz.chunk(2, dim=-1)
    lead = xm.shape[:-1]
    q = act.head_split(xm @ p["wq"], H).reshape(*lead, H, dh)
    k = act.head_split(xm @ p["wk"], H).reshape(*lead, H, dh).float() \
        / math.sqrt(dh)
    v = act.head_split(xm @ p["wv"], H).reshape(*lead, H, dh)
    gates = xm.float() @ p["gates_w"] + p["gates_b"]
    li, lf_raw = gates.chunk(2, dim=-1)                     # (B,S,H)
    if act.on_mesh("aten::log_sigmoid (as -logaddexp(0, -x))"):
        # DTensor has no strategy for log_sigmoid's backward
        lf = -torch.logaddexp(torch.zeros((), device=lf_raw.device), -lf_raw)
    else:
        lf = F.logsigmoid(lf_raw)
    return q, k, v, li, lf, z


def _mlstm_step(carry, inp):
    """One stabilized mLSTM cell step.

    carry: C (B,H,dhv,dhk), n (B,H,dhk), m (B,H)
    inp:   q,k,v (B,H,dh), li,lf (B,H)
    """
    C, n, m = carry
    q, k, v, li, lf = inp
    qf, kf, vf = q.float(), k.float(), v.float()
    m_new = torch.maximum(lf + m, li)
    i_g = torch.exp(li - m_new)[..., None]                  # (B,H,1)
    f_g = torch.exp(lf + m - m_new)[..., None]
    C = f_g[..., None] * C + i_g[..., None] * (vf[..., :, None]
                                               * kf[..., None, :])
    n = f_g * n + i_g * kf
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.maximum((n * qf).sum(-1).abs(),
                        torch.exp(-m_new))[..., None]
    h = num / den
    return (C, n, m_new), h


# Chunked remat of the recurrent time loops: under autograd the carry is
# checkpointed every LSTM_CHUNK[0] steps (torch.utils.checkpoint over each
# chunk of the loop), so the backward keeps O(S/C · state) residuals and
# recomputes a chunk's forward. The forward's numbers do not depend on it.
# None is the naive loop: residuals at every step, no recompute.
LSTM_CHUNK = [64]


def set_lstm_chunk(c):
    LSTM_CHUNK[0] = c


def _time_loop(step, carry, xs, S: int, name: str, weights=()):
    """``step(carry, x_t, *weights) -> (carry, y_t)`` over the S steps of
    the (B, S, ...) inputs ``xs``; returns (final carry, [y_t] * S).
    Chunked and checkpointed under autograd when S is a multiple of the
    chunk ``LSTM_CHUNK[0]`` above it; while the dry run's counter counts,
    one chunk is traced and counted S / chunk times
    (:func:`_rolled_time_loop`). A chunk of ``None`` runs (and the dry run
    counts) every step.
    """
    def run(carry, lo, hi, xs=xs, weights=weights):
        ys = []
        for t in range(lo, hi):
            carry, y = step(carry, tuple(x[:, t] for x in xs), *weights)
            ys.append(y)
        return carry, ys

    Q = LSTM_CHUNK[0]
    if not (Q and S > Q and S % Q == 0):
        return run(carry, 0, S)
    if scan_config.rolled():
        return _rolled_time_loop(run, carry, xs, weights, S, name, Q)
    if not torch.is_grad_enabled():
        return run(carry, 0, S)
    n_c = len(carry)
    ys = []
    for lo in range(0, S, Q):
        def body(*c, lo=lo):
            c2, ys_c = run(c, lo, lo + Q)
            return (*c2, torch.stack(ys_c, 1))
        out = checkpoint(body, *carry, use_reentrant=False)
        carry, hs_c = out[:n_c], out[n_c]
        ys.extend(hs_c.unbind(1))
    return carry, ys


def _rolled_time_loop(run, carry, xs, weights, S: int, name: str, Q: int):
    """The time loop as the dry run counts it: the first ``Q`` steps (one
    chunk) traced, under the counter's scale of S / Q; the chunk's outputs
    stand for every chunk's. The chunk indexes the whole inputs a step at
    a time, as the loop does, so its backward moves what each chunk's
    does."""
    trips = S // Q
    if not torch.is_grad_enabled():
        with scan_config.loop_scope(name, trips):
            carry, ys = run(carry, 0, Q)
        return carry, ys * trips
    n_c, n_x = len(carry), len(xs)

    def body(*ts):
        c2, ys_c = run(ts[:n_c], 0, Q, ts[n_c:n_c + n_x], ts[n_c + n_x:])
        return (*c2, torch.stack(ys_c, 1))

    out = scan_config.rolled_call(body, name, trips,
                                  (*carry, *xs, *weights), n_c)
    return out[:n_c], list(out[n_c].unbind(1)) * trips


def mlstm_train(p: dict, cfg: ArchConfig, x: torch.Tensor,
                return_state: bool = False):
    B, S, D = x.shape
    H = cfg.n_heads
    q, k, v, li, lf, z = _mlstm_qkvg(p, cfg, x)
    dh = q.shape[-1]
    di = dh * H
    carry = init_mlstm_state(cfg, B, device=x.device)
    (C, n, m), hs = _time_loop(_mlstm_step,
                               (carry["C"], carry["n"], carry["m"]),
                               (q, k, v, li, lf), S, "mlstm_time")
    # placed like a wide intermediate, so that its gradient, split over
    # 'model', is gathered before it is viewed as heads again
    h = act.ffn_hidden(torch.stack(hs, 1).reshape(B, S, di))
    h = rms_norm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    h = h * silu(z)
    out = h @ p["out_proj"]
    if return_state:
        return out, {"C": C, "n": n, "m": m}
    return out


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None,
                     lead: tuple = ()) -> dict:
    H = cfg.n_heads
    dh = _mlstm_inner(cfg) // H
    f32 = torch.float32
    return {
        "C": torch.zeros((*lead, batch, H, dh, dh), dtype=f32, device=device),
        "n": torch.zeros((*lead, batch, H, dh), dtype=f32, device=device),
        "m": torch.full((*lead, batch, H), -1e30, dtype=f32, device=device),
    }


def mlstm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 state: dict) -> tuple[torch.Tensor, dict]:
    B = x.shape[0]
    H = cfg.n_heads
    q, k, v, li, lf, z = _mlstm_qkvg(p, cfg, x)             # S == 1
    carry = (state["C"], state["n"], state["m"])
    inp = tuple(t[:, 0] for t in (q, k, v, li, lf))
    (C, n, m), h = _mlstm_step(carry, inp)                  # h (B,H,dh)
    h = h.reshape(B, 1, h.shape[-1] * H)
    h = rms_norm(h.to(x.dtype), p["norm"], cfg.norm_eps)
    h = h * silu(z)
    return h @ p["out_proj"], {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, true recurrence)
# ---------------------------------------------------------------------------

def init_slstm(cfg: ArchConfig, generator: torch.Generator) -> dict:
    D = cfg.d_model
    di = D
    dt = dtype_of(cfg.param_dtype)
    dev = draw_device(generator)
    f32 = torch.float32
    gates_w = dense_init(generator, D, 4 * di, f32)
    r_gates_w = dense_init(generator, di, 4 * di, f32) / math.sqrt(di)
    return {
        "gates_w": gates_w,
        "r_gates_w": r_gates_w,
        "gates_b": torch.cat([
            torch.zeros((di,), dtype=f32, device=dev),
            torch.full((di,), 3.0, dtype=f32, device=dev),   # forget bias
            torch.zeros((2 * di,), dtype=f32, device=dev),
        ]),
        "out_proj": dense_init(generator, di, D, dt),
    }


def _slstm_step(p, carry, x_t):
    """x_t (B, 4di) pre-projected input contribution."""
    c, n, h, m = carry
    raw = x_t + h @ p["r_gates_w"] + p["gates_b"]
    li, lf, z_raw, o_raw = raw.chunk(4, dim=-1)  # lf: log forget gate
    m_new = torch.maximum(lf + m, li)
    i_g = torch.exp(li - m_new)
    f_g = torch.exp(lf + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_raw)
    n = torch.maximum(f_g * n + i_g, torch.exp(-m_new))
    h = torch.sigmoid(o_raw) * c / n
    return (c, n, h, m_new)


def slstm_train(p: dict, cfg: ArchConfig, x: torch.Tensor,
                return_state: bool = False):
    B, S, D = x.shape
    xg = x.float() @ p["gates_w"]                           # (B,S,4di)

    def step(carry, inp, r_gates_w, gates_b):
        new = _slstm_step({"r_gates_w": r_gates_w, "gates_b": gates_b},
                          carry, inp[0])
        return new, new[2]

    st = init_slstm_state(cfg, B, device=x.device)
    (c, n, hh, m), hs = _time_loop(step, (st["c"], st["n"], st["h"],
                                          st["m"]), (xg,), S, "slstm_time",
                                   (p["r_gates_w"], p["gates_b"]))
    h = torch.stack(hs, 1).to(x.dtype)                      # (B,S,di)
    out = h @ p["out_proj"]
    if return_state:
        return out, {"c": c, "n": n, "h": hh, "m": m}
    return out


def init_slstm_state(cfg: ArchConfig, batch: int, device=None,
                     lead: tuple = ()) -> dict:
    shape = (*lead, batch, cfg.d_model)
    f32 = torch.float32
    return {
        "c": torch.zeros(shape, dtype=f32, device=device),
        "n": torch.ones(shape, dtype=f32, device=device),
        "h": torch.zeros(shape, dtype=f32, device=device),
        "m": torch.zeros(shape, dtype=f32, device=device),
    }


def slstm_decode(p: dict, cfg: ArchConfig, x: torch.Tensor,
                 state: dict) -> tuple[torch.Tensor, dict]:
    xg = x[:, 0].float() @ p["gates_w"]
    carry = (state["c"], state["n"], state["h"], state["m"])
    c, n, h, m = _slstm_step(p, carry, xg)
    out = (h.to(x.dtype) @ p["out_proj"])[:, None]
    return out, {"c": c, "n": n, "h": h, "m": m}
