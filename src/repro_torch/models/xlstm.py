"""xLSTM blocks (arXiv:2405.04517; ``repro/models/xlstm.py``): mLSTM (matrix
memory, parallelizable) and sLSTM (scalar memory with a true recurrence),
in PyTorch.

mLSTM runs the stabilized parallel (quadratic) form, or chunkwise-parallel
with an inter-chunk (C, n, m) carry when the sequence is a multiple of
``MLSTM_CHUNK`` above one chunk (a Python loop over chunks where the
reference scans); decode is the O(1) recurrent update of the matrix state
C (dh x dh a head), the normalizer n and the stabilizer m.  sLSTM is a real
recurrence (block-diagonal hidden-to-hidden R): a Python loop over time.

The prefill state of the quadratic form is computed in closed form: the
chunked form's end-of-chunk update over one chunk of S from the zero state,
``m = max_j(F_S - F_j + i_j)``, ``C = sum_j exp(F_S - F_j + i_j - m)
k_j v_j^T`` and n likewise, where the reference runs the per-token
recurrence over the sequence (the same function up to rounding; S eager
steps a layer here would be ~10 launches a token).

Decode updates the state dicts ``{"C", "n", "m"}`` and ``{"c", "n", "h",
"m"}`` in place, in the reference's operation order (``f_eff * C +
i_eff * (k v^T)``), and returns them.  States are f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..configs.base import ArchConfig
from .blocks import dense_init, rmsnorm

__all__ = ["MLSTM_CHUNK", "mlstm_init", "mlstm_apply", "mlstm_decode",
           "make_mlstm_state", "slstm_init", "slstm_apply", "slstm_decode",
           "make_slstm_state"]

MLSTM_CHUNK = 256


# ===========================================================================
# mLSTM
# ===========================================================================
def _mlstm_dims(cfg: ArchConfig):
    di = 2 * cfg.d_model          # proj factor 2
    H = cfg.n_heads
    return di, H, di // H


def mlstm_init(generator, cfg: ArchConfig, dtype=torch.float32,
               lead: tuple = ()):
    D = cfg.d_model
    di, H, dh = _mlstm_dims(cfg)
    return {
        "w_up": dense_init(generator, D, 2 * di, dtype, lead),  # [path, gate]
        "wq": dense_init(generator, di, di, dtype, lead),
        "wk": dense_init(generator, di, di, dtype, lead),
        "wv": dense_init(generator, di, di, dtype, lead),
        "w_if": dense_init(generator, di, 2 * H, dtype, lead),  # i/f preacts
        "out_norm": torch.ones(*lead, di, dtype=dtype,
                               device=generator.device),
        "w_down": dense_init(generator, di, D, dtype, lead),
    }


def _mlstm_qkvif(p, x, cfg: ArchConfig):
    B, S, D = x.shape
    di, H, dh = _mlstm_dims(cfg)
    up = x @ p["w_up"]
    a, g = up[..., :di], up[..., di:]
    q = (a @ p["wq"]).reshape(B, S, H, dh)
    k = (a @ p["wk"]).reshape(B, S, H, dh) / math.sqrt(dh)
    v = (a @ p["wv"]).reshape(B, S, H, dh)
    i_f = (a @ p["w_if"]).float()
    return q, k, v, i_f[..., :H], i_f[..., H:], g


def _mlstm_out(p, y, g, x, cfg: ArchConfig):
    """(B, S, di) f32 hidden -> the block's output (B, S, D)."""
    y = rmsnorm(y.to(x.dtype), p["out_norm"], cfg.norm_eps)
    return (y * F.silu(g)) @ p["w_down"]


def mlstm_apply(p, x, cfg: ArchConfig, return_state: bool = False):
    """mLSTM forward, x: (B, S, D): chunkwise-parallel when S is a multiple
    of MLSTM_CHUNK above one chunk, the stabilized quadratic form
    otherwise (the reference's choice); with ``return_state`` -> (y,
    {"C", "n", "m"})."""
    S = x.shape[1]
    if S % MLSTM_CHUNK == 0 and S > MLSTM_CHUNK:
        return _mlstm_chunked(p, x, cfg, return_state)
    return _mlstm_quadratic(p, x, cfg, return_state)


def _end_state(kf, vf, i_pre, F_cum, m0=None, C0=None, n0=None):
    """The state after a chunk: kf, vf (B, Q, H, dh) f32, i_pre and the
    within-chunk cumulative log-forget F_cum (B, Q, H), from the state (C0,
    n0, m0) before it (None: the zero state)."""
    F_end = F_cum[:, -1, :]                                  # (B,H)
    decay = F_end[:, None, :] - F_cum + i_pre                # (B,Q,H)
    m_new = decay.amax(dim=1)
    if m0 is not None:
        m_new = torch.maximum(F_end + m0, m_new)
    upd_w = torch.exp(decay - m_new[:, None, :])             # (B,Q,H)
    kw = kf * upd_w[..., None]                               # (B,Q,H,dh)
    C = kw.permute(0, 2, 3, 1) @ vf.transpose(1, 2)          # (B,H,dh,dh)
    n = kw.sum(dim=1)                                        # (B,H,dh)
    if m0 is not None:
        carry_w = torch.exp(F_end + m0 - m_new)              # (B,H)
        C = carry_w[..., None, None] * C0 + C
        n = carry_w[..., None] * n0 + n
    return {"C": C, "n": n, "m": m_new}


def _mlstm_quadratic(p, x, cfg: ArchConfig, return_state: bool = False):
    """Parallel (stabilized quadratic) form.  x: (B, S, D)."""
    B, S, D = x.shape
    di, H, dh = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, g = _mlstm_qkvif(p, x, cfg)
    logf = F.logsigmoid(f_pre)                               # (B,S,H)
    F_cum = torch.cumsum(logf, dim=1)
    # D_ij = exp(F_i - F_j + i_j), stabilized per row
    dlog = (F_cum[:, :, None, :] - F_cum[:, None, :, :]
            + i_pre[:, None, :, :])                          # (B,Sq,Sk,H)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    dlog = dlog.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = dlog.amax(dim=2, keepdim=True)                       # (B,Sq,1,H)
    Dmat = torch.exp(dlog - m)
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = torch.einsum("bqhd,bkhd->bqkh", qf, kf)
    C = scores * Dmat
    norm = torch.maximum(torch.abs(C.sum(dim=2)), torch.exp(-m[:, :, 0, :]))
    y = torch.einsum("bqkh,bkhd->bqhd", C, vf)
    y = (y / (norm[..., None] + 1e-6)).reshape(B, S, di)
    out = _mlstm_out(p, y, g, x, cfg)
    if not return_state:
        return out
    return out, _end_state(kf, vf, i_pre, F_cum)


def _mlstm_chunked(p, x, cfg: ArchConfig, return_state: bool = False):
    """Chunkwise-parallel mLSTM: the intra-chunk stabilized quadratic form
    plus the inter-chunk recurrent (C, n, m) carry."""
    B, S, D = x.shape
    di, H, dh = _mlstm_dims(cfg)
    Q = MLSTM_CHUNK
    Nc = S // Q
    q, k, v, i_pre, f_pre, g = _mlstm_qkvif(p, x, cfg)
    qf = q.float().reshape(B, Nc, Q, H, dh)
    kf = k.float().reshape(B, Nc, Q, H, dh)
    vf = v.float().reshape(B, Nc, Q, H, dh)
    i_c = i_pre.reshape(B, Nc, Q, H)
    logf = F.logsigmoid(f_pre).reshape(B, Nc, Q, H)
    F_cum = torch.cumsum(logf, dim=2)                        # within-chunk
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    st = make_mlstm_state(cfg, B, device=x.device)
    ys = []
    for c in range(Nc):
        qc, kc, vc, ic, Fc = qf[:, c], kf[:, c], vf[:, c], i_c[:, c], \
            F_cum[:, c]
        # intra-chunk decay D_tj = exp(F_t - F_j + i_j), j <= t
        dl = (Fc[:, :, None, :] - Fc[:, None, :, :]
              + ic[:, None, :, :]).masked_fill(~mask[None, :, :, None],
                                               -1e30)        # (B,Q,K,H)
        m_intra = dl.amax(dim=2)                             # (B,Q,H)
        C0, n0, m0 = st["C"], st["n"], st["m"]
        m_inter = Fc + m0[:, None, :]                        # (B,Q,H)
        m_t = torch.maximum(m_intra, m_inter)
        Dm = torch.exp(dl - m_t[:, :, None, :])
        Cmat = torch.einsum("bqhd,bkhd->bqkh", qc, kc) * Dm
        num_intra = torch.einsum("bqkh,bkhd->bqhd", Cmat, vc)
        den_intra = Cmat.sum(dim=2)                          # (B,Q,H)
        w_inter = torch.exp(m_inter - m_t)                   # (B,Q,H)
        num_inter = torch.einsum("bqhd,bhde->bqhe", qc, C0) \
            * w_inter[..., None]
        den_inter = torch.einsum("bqhd,bhd->bqh", qc, n0) * w_inter
        num = num_intra + num_inter
        den = torch.maximum(torch.abs(den_intra + den_inter),
                            torch.exp(-m_t))
        ys.append(num / (den[..., None] + 1e-6))             # (B,Q,H,dh)
        st = _end_state(kc, vc, ic, Fc, m0, C0, n0)
    y = torch.stack(ys, dim=1).reshape(B, S, di)
    out = _mlstm_out(p, y, g, x, cfg)
    if return_state:
        return out, st
    return out


def make_mlstm_state(cfg: ArchConfig, batch: int, device="cuda",
                     lead: tuple = ()):
    """An empty mLSTM state, f32, on ``device`` (the card unless the caller
    asks for the CPU; with no card it raises)."""
    device = resolve_device(device)
    di, H, dh = _mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros(*lead, batch, H, dh, dh, dtype=f32, device=device),
        "n": torch.zeros(*lead, batch, H, dh, dtype=f32, device=device),
        "m": torch.full((*lead, batch, H), -1e30, dtype=f32, device=device),
    }


def _mlstm_recurrent_update(st, q_t, k_t, v_t, i_t, logf_t):
    """One step of the stabilized mLSTM recurrence (all per (B, H)), in
    place on ``st``: C, n scaled by f_eff and added to; m replaced."""
    m_new = torch.maximum(logf_t + st["m"], i_t)
    f_eff = torch.exp(logf_t + st["m"] - m_new)[..., None]
    i_eff = torch.exp(i_t - m_new)[..., None]
    kf, vf = k_t.float(), v_t.float()
    kv = (kf[..., :, None] * vf[..., None, :]).mul_(i_eff[..., None])
    st["C"].mul_(f_eff[..., None]).add_(kv)
    st["n"].mul_(f_eff).add_(i_eff * kf)
    st["m"].copy_(m_new)
    return st


def mlstm_decode(p, x, cfg: ArchConfig, state):
    """Single-token step.  x: (B, 1, D); ``state`` from
    :func:`make_mlstm_state` (or a prefill), updated in place and returned:
    -> (y (B, 1, D), state)."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"mlstm_decode takes one token a row, got S={S}")
    di, H, dh = _mlstm_dims(cfg)
    q, k, v, i_pre, f_pre, g = _mlstm_qkvif(p, x, cfg)
    st = _mlstm_recurrent_update(state, q[:, 0], k[:, 0], v[:, 0],
                                 i_pre[:, 0], F.logsigmoid(f_pre[:, 0]))
    qf = q[:, 0].float()                                     # (B,H,dh)
    h_num = (qf[:, :, None, :] @ st["C"])[:, :, 0, :]        # sum_d q_d C_de
    h_den = torch.maximum(torch.abs((st["n"] * qf).sum(dim=-1)),
                          torch.exp(-st["m"]))
    y = (h_num / (h_den[..., None] + 1e-6)).reshape(B, 1, di)
    return _mlstm_out(p, y, g, x, cfg), st


# ===========================================================================
# sLSTM
# ===========================================================================
def _slstm_dims(cfg: ArchConfig):
    di = cfg.d_model
    H = cfg.n_heads
    return di, H, di // H


def slstm_init(generator, cfg: ArchConfig, dtype=torch.float32,
               lead: tuple = ()):
    D = cfg.d_model
    di, H, dh = _slstm_dims(cfg)
    dev = generator.device
    f_ff = max(1, int(4 * D / 3) // 8 * 8)
    return {
        "w_gates": dense_init(generator, D, 4 * di, dtype, lead),  # z,i,f,o
        "r_gates": torch.randn(*lead, H, dh, 4 * dh, generator=generator,
                               device=dev).div_(math.sqrt(dh)).to(dtype),
        "b_gates": torch.zeros(*lead, 4 * di, dtype=dtype, device=dev),
        "out_norm": torch.ones(*lead, di, dtype=dtype, device=dev),
        "ff_up": dense_init(generator, di, f_ff, dtype, lead),
        "ff_down": dense_init(generator, f_ff, D, dtype, lead),
    }


def make_slstm_state(cfg: ArchConfig, batch: int, device="cuda",
                     lead: tuple = ()):
    """An empty sLSTM state, f32, on ``device`` (the card unless the caller
    asks for the CPU; with no card it raises)."""
    device = resolve_device(device)
    di, H, dh = _slstm_dims(cfg)
    shape = (*lead, batch, H, dh)
    f32 = torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.full(shape, 1e-6, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, -1e30, dtype=f32, device=device)}


def _slstm_step(p, cfg: ArchConfig, st, wx_t):
    """wx_t: (B, 4*di), the input's contribution at time t -> the next
    state (a new dict)."""
    di, H, dh = _slstm_dims(cfg)
    B = wx_t.shape[0]
    rec = torch.einsum("bhd,hdk->bhk", st["h"],
                       p["r_gates"].float())                 # (B,H,4*dh)
    pre = wx_t.reshape(B, 4, H, dh).float() \
        + rec.reshape(B, H, 4, dh).movedim(2, 1)
    z = torch.tanh(pre[:, 0])
    i_pre, f_pre, o_pre = pre[:, 1], pre[:, 2], pre[:, 3]
    o = torch.sigmoid(o_pre)
    m_new = torch.maximum(f_pre + st["m"], i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(f_pre + st["m"] - m_new)
    c = f_eff * st["c"] + i_eff * z
    n = f_eff * st["n"] + i_eff
    h = o * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p, h, x, cfg: ArchConfig):
    """(B, S, di) f32 hidden -> the block's output (B, S, D)."""
    y = rmsnorm(h.to(x.dtype), p["out_norm"], cfg.norm_eps)
    return F.gelu(y @ p["ff_up"], approximate="tanh") @ p["ff_down"]


def slstm_apply(p, x, cfg: ArchConfig, return_state: bool = False):
    """True recurrence, a loop over time.  x: (B, S, D); with
    ``return_state`` -> (y, {"c", "n", "h", "m"})."""
    B, S, D = x.shape
    di, H, dh = _slstm_dims(cfg)
    wx = x @ p["w_gates"] + p["b_gates"]
    st = make_slstm_state(cfg, B, device=x.device)
    hs = []
    for t in range(S):
        st = _slstm_step(p, cfg, st, wx[:, t])
        hs.append(st["h"])
    out = _slstm_out(p, torch.stack(hs, dim=1).reshape(B, S, di), x, cfg)
    if return_state:
        return out, st
    return out


def slstm_decode(p, x, cfg: ArchConfig, state):
    """Single-token step.  x: (B, 1, D); ``state`` updated in place and
    returned: -> (y (B, 1, D), state)."""
    B, S, D = x.shape
    if S != 1:
        raise ValueError(f"slstm_decode takes one token a row, got S={S}")
    di, H, dh = _slstm_dims(cfg)
    wx = (x @ p["w_gates"] + p["b_gates"])[:, 0]
    new = _slstm_step(p, cfg, state, wx)
    for key, t in new.items():
        state[key].copy_(t)
    return _slstm_out(p, new["h"].reshape(B, 1, di), x, cfg), state
