"""Mamba-2 SSD (state-space duality) layer (the port of
``repro.models.ssm``).

Chunked SSD algorithm (Dao & Gu 2024): split the sequence into chunks;
within a chunk the recurrence is materialized as a decay-masked
attention-like quadratic form, across chunks a loop carries the
[heads, head_dim, state] SSM state.  Decode is the O(1)/token recurrence.

Every contraction of three operands is written as two explicit steps, so
no [B, nc, Q, K, H, P] intermediate forms (``torch.einsum`` would pick its
own path).  The reference's ``shard_hint`` calls are in place
(``repro_torch.sharding.shard_hint``: the identity on per-rank tensors).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _he, _zeros, rms_norm
from repro_torch.sharding import shard_hint


def init_ssm(gen, cfg: ModelConfig, *, lead=()):
    d = cfg.d_model
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    lead = tuple(lead)
    dev = gen.device
    u = torch.rand(lead + (nh,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
    return {
        "in_proj": _he(gen, (d, 2 * di + 2 * ds + nh), lead=lead),
        "conv_w": torch.randn(lead + (cfg.conv_width, conv_dim),
                              generator=gen, device=dev) * 0.1,
        "conv_b": _zeros(gen, (conv_dim,), lead=lead),
        "A_log": a_log.expand(lead + (nh,)).clone(),
        "D": torch.ones(lead + (nh,), device=dev),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus
        "norm": _zeros(gen, (di,), lead=lead),
        "out_proj": _he(gen, (di, d), lead=lead),
    }


def _split_proj(p, x, cfg: ModelConfig):
    di, ds = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * ds]
    dt_raw = zxbcdt[..., 2 * di + 2 * ds:]
    return z, xbc, dt_raw


def _causal_conv(xbc, conv_w, conv_b, *, tail=None, act: str = "silu"):
    """Depthwise causal conv over time. xbc: [B,S,C]; conv_w: [W,C]."""
    w = conv_w.shape[0]
    if tail is None:
        pad = xbc.new_zeros(xbc.shape[:1] + (w - 1,) + xbc.shape[2:])
    else:
        pad = tail.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [B, S+W-1, C]
    out = xp[:, 0: xbc.shape[1]] * conv_w[0].to(xbc.dtype)
    for i in range(1, w):
        out = out + xp[:, i: i + xbc.shape[1]] * conv_w[i].to(xbc.dtype)
    out = out + conv_b.to(xbc.dtype)
    if act == "silu":
        out = F.silu(out)
    return out, xp[:, -(w - 1):] if w > 1 else None


def ssd_chunked(xh, dt, a_log, b_mat, c_mat, *, chunk: int, init_state=None,
                intra_dtype=torch.float32):
    """Chunked SSD scan.

    xh: [B,S,H,P] inputs (head-split), dt: [B,S,H] (post-softplus),
    b_mat/c_mat: [B,S,N] (ngroups=1 shared over heads).
    Returns y: [B,S,H,P] and final state [B,H,P,N].

    ``intra_dtype``: dtype of the intra-chunk quadratic operands (decay /
    scores / dt-weighted inputs); the recurrence statistics (cum, carry
    state) and the sums that leave a chunk stay f32.
    """
    bsz, s, h, pdim = xh.shape
    n = b_mat.shape[-1]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    a = -torch.exp(a_log)  # [H], negative
    dta = dt * a  # [B,S,H] log-decay per step
    xdt = xh * dt[..., None]  # dt-weighted input

    xc = xdt.reshape(bsz, nc, chunk, h, pdim)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)
    dtac = dta.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(dtac, dim=2)  # [B,nc,Q,H]

    cd = intra_dtype

    def f32(t):  # the operand rounded to cd, summed in f32
        return t.to(cd).float()

    # intra-chunk quadratic (the "duality" form): (scores ⊙ decay), then
    # one product over k
    scores = torch.einsum("bcqn,bckn->bcqk", cc.to(cd), bc.to(cd))
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # cum_q - cum_k
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xh.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                        0.0).to(cd)
    w = scores[..., None] * decay  # [B,nc,Q,K,H]
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", f32(w), f32(xc))

    # chunk states: sum_k exp(cum_last - cum_k) B_k x_k^T
    seg = torch.exp(cum[:, :, -1:, :] - cum)  # [B,nc,Q,H]
    sx = (seg.to(cd)[..., None] * xc.to(cd))  # [B,nc,Q,H,P]
    states = torch.einsum("bckn,bckhp->bchpn", f32(bc), f32(sx))
    states = shard_hint(states, "batch", None, "heads", None, None)

    # inter-chunk recurrence
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H]
    if init_state is None:
        init_state = xh.new_zeros((bsz, h, pdim, n), dtype=torch.float32)
    init_state = shard_hint(init_state, "batch", "heads", None, None)
    st = init_state
    prevs = []
    for c in range(nc):
        prevs.append(st)
        st = st * chunk_decay[:, c][:, :, None, None] + states[:, c]
    final_state = st
    prev_states = torch.stack(prevs, dim=1)  # [B,nc,H,P,N]

    # inter-chunk contribution: C_q · (decayed carry-in state)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", f32(cc), f32(prev_states))
    y_off = y_off * f32(torch.exp(cum))[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, pdim)
    return y, final_state


def ssm_forward(p, x, cfg: ModelConfig, *, init_state=None, conv_tail=None,
                return_state: bool = False):
    """Full-sequence SSD block. x: [B,S,d] -> [B,S,d]."""
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    bsz, s, _ = x.shape
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    xbc, tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], tail=conv_tail)
    xh = xbc[..., :di].reshape(bsz, s, nh, hd)
    b_mat = xbc[..., di: di + ds]
    c_mat = xbc[..., di + ds:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,S,H]
    xh = shard_hint(xh, "batch", "seq", "heads", None)
    chunk = min(cfg.ssm_chunk, s)
    while s % chunk:  # largest divisor of s not exceeding the target
        chunk -= 1
    y, state = ssd_chunked(
        xh.float(), dt, p["A_log"], b_mat.float(), c_mat.float(),
        chunk=chunk, init_state=init_state,
        intra_dtype=torch.bfloat16 if cfg.ssm_bf16_intra else torch.float32)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, {"state": state, "conv": tail}
    return out


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device="cuda", *,
                   lead=()):
    di, ds = cfg.d_inner, cfg.ssm_state
    lead = tuple(lead)
    return {
        "state": torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                     ds), dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, di + 2 * ds),
                            dtype=dtype, device=device),
    }


def ssm_decode_step(p, x, cache, cfg: ModelConfig):
    """One-token recurrence. x: [B,1,d]."""
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    hd = cfg.ssm_head_dim
    bsz = x.shape[0]
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    # conv over [tail, current]
    window = torch.cat([cache["conv"].to(x.dtype), xbc], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"]) \
        + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :].to(x.dtype)
    xh = xbc1[..., :di].reshape(bsz, nh, hd).float()
    b_mat = xbc1[:, 0, di: di + ds].float()
    c_mat = xbc1[:, 0, di + ds:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt * a)  # [B,H]
    state = cache["state"] * da[..., None, None] \
        + (dt[..., None] * xh)[..., None] * b_mat[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", state, c_mat)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    new_cache = {"state": state,
                 "conv": window[:, 1:].to(cache["conv"].dtype)}
    return out, new_cache
