"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

The JAX package's ``models/ssm.py`` on torch tensors. Prefill uses the
chunked SSD algorithm: within-chunk quadratic (matmul form) plus an
across-chunk linear recurrence. On a CUDA tensor ``ssm_apply`` runs the
scan through the hand-written kernel (``kernels/ssd_scan``); on a CPU
tensor through :func:`ssd_chunked`, the plain version; a meta tensor
through the plain version or, inside ``kernels.on_meta()``, the
kernel's shape-only route (``launch/costing.py``). Decode is the
O(1) recurrent state update, plain torch.

Projections stay separate matrices (z, x, B, C, dt), with a single B/C
group, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import Params, dense_init, dtype_of

SSMState = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def ssm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    dev = gen.device
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    nh = cfg.ssm_n_heads
    u = torch.rand((nh,), generator=gen, device=dev)
    dt_init = torch.log(torch.expm1(torch.exp(
        u * (np.log(0.1) - np.log(0.001)) + np.log(0.001))))

    def conv_w(ch: int) -> torch.Tensor:
        w = torch.randn((cfg.ssm_conv, ch), generator=gen, device=dev)
        return (w * (1.0 / np.sqrt(cfg.ssm_conv * ch))).to(dt)

    return {
        "w_z": dense_init(gen, d, di, dt),
        "w_x": dense_init(gen, d, di, dt),
        "w_B": dense_init(gen, d, n, dt),
        "w_C": dense_init(gen, d, n, dt),
        "w_dt": dense_init(gen, d, nh, dt),
        "conv_wx": conv_w(di),
        "conv_bx": torch.zeros((di,), dtype=dt, device=dev),
        "conv_wB": conv_w(n),
        "conv_bB": torch.zeros((n,), dtype=dt, device=dev),
        "conv_wC": conv_w(n),
        "conv_bC": torch.zeros((n,), dtype=dt, device=dev),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": dt_init,
        "norm_scale": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, di, d, dt,
                               scale=1.0 / np.sqrt(2 * cfg.n_layers)),
    }


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (K, C).

    Written as K shifted multiply-adds in f32, rounded once to x's type,
    rather than through cuDNN, whose default for an f32 convolution on
    the card is TF32 (about three decimal digits)."""
    k, length = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = xp[:, 0:length] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + length] * wf[i]
    return out.to(x.dtype) + b.to(x.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(y * silu(z)) * scale."""
    g = y.float() * F.silu(z.float())
    var = g.square().mean(dim=-1, keepdim=True)
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the plain version of the SSD kernel.

    x: (b, l, h, p); dt: (b, l, h) (post-softplus); A: (h,) (negative);
    B, C: (b, l, n). Returns (y (b, l, h, p), final_state (b, h, p, n)).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    L = l + pad
    nc = L // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * A[None, None, None, :]                    # (b, nc, q, h) <= 0
    seg = torch.cumsum(dA, dim=2)                        # within-chunk cumsum
    seg_last = seg[:, :, -1:, :]                         # (b, nc, 1, h)

    # ---- intra-chunk (quadratic, matmul form) ----
    G = torch.einsum("bcqn,bckn->bcqk", Cc.float(), Bc.float())
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (b, nc, q, k, h)
    ii = torch.arange(chunk, device=x.device)
    tri = ii[:, None] >= ii[None, :]
    # a select, never a multiply: exp(diff) is inf above the diagonal. The
    # select comes before the exp, so that the gradient above the diagonal
    # is 0 and not 0 * inf = NaN (the reference selects after it, and its
    # autodiff gives NaN for dt and A at strong decay: ROADMAP C3)
    decay = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                  float("-inf")))
    att = G[:, :, :, :, None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att.to(x.dtype), xc)

    # ---- chunk summary states ----
    decay_to_end = torch.exp(seg_last - seg)             # (b, nc, q, h)
    weighted_x = xc * (dtc * decay_to_end)[..., None].to(x.dtype)
    S = torch.einsum("bcqn,bcqhp->bchpn", Bc, weighted_x)

    # ---- inter-chunk recurrence ----
    chunk_decay = torch.exp(seg_last[:, :, 0, :])        # (b, nc, h)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    priors = []
    for c in range(nc):
        priors.append(state)
        state = chunk_decay[:, c, :, None, None] * state + S[:, c].float()
    prior_states = torch.stack(priors, dim=1)            # (b, nc, h, p, n)

    # ---- inter-chunk contribution ----
    Cdec = Cc[:, :, :, None, :].float() * torch.exp(seg)[..., None]
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cdec.to(x.dtype),
                           prior_states.to(x.dtype))
    y = (y_intra + y_inter).reshape(b, L, h, p)[:, :l]
    return y, state.to(x.dtype)


# ---------------------------------------------------------------------------
# Mixer: full-sequence apply (train / prefill)
# ---------------------------------------------------------------------------

def ssm_apply(params: Params, u: torch.Tensor, cfg: ModelConfig,
              init_state: Optional[torch.Tensor] = None,
              return_cache: bool = False):
    """u: (B, L, d_model) -> (out, final_state) or, with ``return_cache``,
    (out, (conv_cache (B, K-1, di+2n), ssd_state (B, nh, p, n)))."""
    bsz, l, _ = u.shape
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    z = u @ params["w_z"]
    xr_raw = u @ params["w_x"]
    Br_raw = u @ params["w_B"]
    Cr_raw = u @ params["w_C"]
    dt_raw = u @ params["w_dt"]
    xr = F.silu(_causal_conv(xr_raw, params["conv_wx"], params["conv_bx"]))
    Bm = F.silu(_causal_conv(Br_raw, params["conv_wB"], params["conv_bB"]))
    Cm = F.silu(_causal_conv(Cr_raw, params["conv_wC"], params["conv_bC"]))
    xs = xr.reshape(bsz, l, nh, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    scan = ssd_ops.ssd_scan
    if xs.device.type == "meta":           # shapes only: launch/costing.py
        scan = ssd_ops.ssd_scan_meta if kernels.ON_META else ssd_chunked
    y, state = scan(xs, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + xs * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, l, di)
    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if not return_cache:
        return out, state
    # conv cache = last K-1 *pre-conv* rows (what decode's window expects)
    k = cfg.ssm_conv
    raw = torch.cat([xr_raw, Br_raw, Cr_raw], dim=-1)    # (B, L, di+2n)
    if l >= k - 1:
        tail = raw[:, l - (k - 1):, :]
    else:
        tail = F.pad(raw, (0, 0, k - 1 - l, 0))
    return out, (tail, state)


# ---------------------------------------------------------------------------
# Decode: O(1) recurrent update
# ---------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int,
                   n_layers: Optional[int] = None,
                   device: Optional[torch.device] = None) -> SSMState:
    dt = dtype_of(cfg)
    L = n_layers if n_layers is not None else cfg.n_layers
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dt, device=device),
        "ssd": torch.zeros((L, batch, cfg.ssm_n_heads, cfg.ssm_head_dim, n),
                           dtype=dt, device=device),
    }


def ssm_decode_step(params: Params, u: torch.Tensor, cfg: ModelConfig,
                    conv_state: torch.Tensor, ssd_state: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. u: (B, 1, d). conv_state: (B, K-1, di+2n);
    ssd_state: (B, nh, p, n). Returns (out, conv_state, ssd_state) as
    new tensors."""
    bsz = u.shape[0]
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    ut = u[:, 0, :]
    z = ut @ params["w_z"]
    xr = ut @ params["w_x"]
    Br = ut @ params["w_B"]
    Cr = ut @ params["w_C"]
    dt_raw = ut @ params["w_dt"]

    new_in = torch.cat([xr, Br, Cr], dim=-1)              # (B, di+2n)
    window = torch.cat([conv_state, new_in[:, None, :]], dim=1)
    conv_w = torch.cat(
        [params["conv_wx"], params["conv_wB"], params["conv_wC"]], dim=-1)
    conv_b = torch.cat(
        [params["conv_bx"], params["conv_bB"], params["conv_bC"]], dim=-1)
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w.to(u.dtype))
    mixed = F.silu(conv_out + conv_b.to(u.dtype))
    new_conv_state = window[:, 1:, :]
    xs = mixed[..., :di].reshape(bsz, nh, p)
    Bm = mixed[..., di:di + n]
    Cm = mixed[..., di + n:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt * A[None, :])                                 # (B, nh)
    upd = (dt[..., None] * xs.float())[..., :, None] \
        * Bm.float()[:, None, None, :]                              # (B,nh,p,n)
    state = dA[..., None, None] * ssd_state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + xs.float() * params["D"][None, :, None]
    y = y.reshape(bsz, di).to(u.dtype)
    y = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None, :]
    return (out, new_conv_state.to(conv_state.dtype),
            state.to(ssd_state.dtype))
