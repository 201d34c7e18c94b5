"""RG-LRU recurrent block (Griffin / RecurrentGemma; the port of
``repro.models.rglru``).

The Real-Gated Linear Recurrent Unit:
    r_t = σ(W_a u_t + b_a)            (recurrence gate)
    i_t = σ(W_i u_t + b_i)            (input gate)
    a_t = exp(c · r_t · log σ(Λ))     (gated decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

The full sequence runs the recurrence as a Hillis-Steele scan (log2 S
elementwise steps); the reference's ``associative_scan`` combines in
another order, so the two agree to f32 rounding, not bit for bit.
Decode is one multiply-add per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _he, _zeros, gelu
from repro_torch.models.ssm import _causal_conv

C_FACTOR = 8.0


def init_rglru(gen, cfg: ModelConfig, *, lead=()):
    d = cfg.d_model
    w = cfg.lru_width or d
    lead = tuple(lead)
    dev = gen.device
    # Λ such that a^c = σ(Λ)^c is uniform in [0.9, 0.999] (Griffin init)
    u = torch.rand(lead + (w,), generator=gen, device=dev) * 0.099 + 0.9
    a0 = u ** (1.0 / C_FACTOR)
    lam = torch.log(a0 / (1.0 - a0))
    return {
        "wx": _he(gen, (d, w), lead=lead),
        "wg": _he(gen, (d, w), lead=lead),
        "conv_w": torch.randn(lead + (cfg.conv_width, w), generator=gen,
                              device=dev) * 0.1,
        "conv_b": _zeros(gen, (w,), lead=lead),
        "ga_w": _he(gen, (w, w), lead=lead),
        "ga_b": _zeros(gen, (w,), lead=lead),
        "gi_w": _he(gen, (w, w), lead=lead),
        "gi_b": _zeros(gen, (w,), lead=lead),
        "lam": lam,
        "out": _he(gen, (w, d), lead=lead),
    }


def _gates(p, u):
    r = torch.sigmoid(u @ p["ga_w"].to(u.dtype)
                      + p["ga_b"].to(u.dtype)).float()
    i = torch.sigmoid(u @ p["gi_w"].to(u.dtype)
                      + p["gi_b"].to(u.dtype)).float()
    log_a = C_FACTOR * r * (-F.softplus(-p["lam"]))  # c·r·logσ(Λ) ≤ 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    b = beta * (i * u.float())
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, as a
    Hillis-Steele scan of the combine (a_l, b_l), (a_r, b_r) ->
    (a_l a_r, b_l a_r + b_r)."""
    s = a.shape[1]
    k = 1
    while k < s:
        b = torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def rglru_forward(p, x, cfg: ModelConfig, *, h0=None, conv_tail=None,
                  return_state: bool = False):
    """x: [B,S,d] -> [B,S,d]."""
    u = x @ p["wx"].to(x.dtype)
    u, tail = _causal_conv(u, p["conv_w"], p["conv_b"], tail=conv_tail,
                           act="none")
    a, b = _gates(p, u)
    if h0 is not None:
        # fold carry-in state into the first step's additive term
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    g = gelu(x @ p["wg"].to(x.dtype)).float()
    y = (h * g).to(x.dtype) @ p["out"].to(x.dtype)
    if return_state:
        return y, {"h": h[:, -1], "conv": tail}
    return y


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device="cuda", *,
                     lead=()):
    w = cfg.lru_width or cfg.d_model
    lead = tuple(lead)
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                            dtype=dtype, device=device),
    }


def rglru_decode_step(p, x, cache, cfg: ModelConfig):
    """x: [B,1,d] -> [B,1,d] with O(1) state update."""
    u = x @ p["wx"].to(x.dtype)  # [B,1,w]
    window = torch.cat([cache["conv"].to(x.dtype), u], dim=1)
    u1 = (torch.einsum("bwc,wc->bc", window.float(), p["conv_w"])
          + p["conv_b"])[:, None, :].to(x.dtype)
    a, b = _gates(p, u1)
    h = a[:, 0] * cache["h"] + b[:, 0]
    g = gelu(x @ p["wg"].to(x.dtype)).float()
    y = (h[:, None] * g).to(x.dtype) @ p["out"].to(x.dtype)
    return y, {"h": h, "conv": window[:, 1:].to(cache["conv"].dtype)}
