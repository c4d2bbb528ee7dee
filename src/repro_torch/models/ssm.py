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

Across ranks that split the ``model`` axis (``sharding.Shard`` leaves,
``ssm_tp``: ``d_inner`` divisible by ``m``) a rank holds ``nh / m``
heads: ``w_z`` / ``w_x`` / ``conv_wx`` split over ``d_inner``, and it
slices ``conv_bx`` / ``norm_scale`` to its channels and ``dt`` /
``A_log`` / ``D`` / ``dt_bias`` to its heads; ``w_B`` / ``w_C`` /
``w_dt`` stay whole. The gated norm's sum of squares runs over the whole
``d_inner``, so it is summed over the ``model`` group before the
``rsqrt`` (GSPMD does this unasked), and ``out_proj``'s partial is
summed over the group. The conv cache holds the rank's ``x`` channels
and the whole B / C.

Split so, the mixer is a region the ``model`` axis partitions, and its
gradient needs these sums over the ``model`` group (what GSPMD derives
from the same layout): the input ``u`` enters through
``sharding.enter``; every leaf ``model`` does not split goes through
``sharding.part_weight`` (:class:`_Local`), since a rank's gradient of
it is its heads' part -- ``w_B`` / ``w_C`` / ``conv_wB`` / ``conv_bB``
/ ``conv_wC`` / ``conv_bC`` (B and C feed only the rank's heads),
``w_dt`` (its columns taken after the product), and ``conv_bx`` /
``norm_scale`` / ``A_log`` / ``D`` / ``dt_bias`` (sliced to the rank's
channels or heads); the gated norm's sum of squares is summed in both
directions (``collectives.model_sum_shared``); ``out_proj``'s partial
leaves through ``collectives.model_sum``. Under the ``seq_model``
policy (``seq=True``) ``u`` is this rank's span of the sequence,
gathered on entry, and the partials are reduce-scattered to the span
(an unsplit mixer computes whole and keeps its span, every leaf then
through ``sharding.part_weight``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.config import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.distributed.context import get_mesh_context
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
                eps: float, d_inner: Optional[int] = None) -> torch.Tensor:
    """Mamba-2 gated RMSNorm: norm(y * silu(z)) * scale. With ``d_inner``
    larger than y's channels (a rank's block of them) the sum of squares
    is summed over the ``model`` group and taken over ``d_inner``."""
    g = y.float() * F.silu(z.float())
    if d_inner is None or d_inner == g.shape[-1]:
        var = g.square().mean(dim=-1, keepdim=True)
    else:
        ss = collectives.model_sum_shared(
            g.square().sum(dim=-1, keepdim=True), get_mesh_context())
        var = ss / d_inner
    return (g * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


class _Local:
    """One SSD layer's weights as this rank computes with them: the
    projections through ``sharding.weight``, the per-channel and
    per-head leaves sliced to the rank's heads, and whether
    ``out_proj``'s partial is summed over ``model``; where the axis
    splits the heads (``partitioned``), every leaf it does not split read
    through ``sharding.part_weight``."""

    def __init__(self, params: Params, cfg: ModelConfig, seq: bool = False):
        self.partitioned = sharding.model_split(params["w_x"], 1)
        # seq: the input is a span, gathered; an unsplit mixer computes
        # whole and keeps the span of its output, so every leaf's
        # gradient is then a part, summed over ``model``
        self.seq = seq
        self.partial = self.partitioned or seq
        w = sharding.part_weight if self.partial else sharding.weight
        di, p = cfg.d_inner, cfg.ssm_head_dim
        c0, nc = sharding.model_block(params["w_x"], 1, di)
        if nc % p:
            raise ValueError(f"{cfg.name}: a rank's {nc} SSD channels are "
                             f"not whole heads of {p}")
        h0, nh = c0 // p, nc // p
        self.d_inner, self.n_heads = nc, nh
        for name in ("w_z", "w_x", "w_B", "w_C", "conv_wx", "conv_wB",
                     "conv_bB", "conv_wC", "conv_bC", "out_proj"):
            setattr(self, name, w(params[name]))
        self.conv_bx = w(params["conv_bx"])[c0:c0 + nc]
        self.norm_scale = w(params["norm_scale"])[c0:c0 + nc]
        self.w_dt_cols = (h0, nh)
        self.w_dt = w(params["w_dt"])
        for name in ("A_log", "D", "dt_bias"):
            setattr(self, name, w(params[name])[h0:h0 + nh])
        self.reduce = sharding.model_split(params["out_proj"], 0)

    def dt_raw(self, u: torch.Tensor) -> torch.Tensor:
        h0, nh = self.w_dt_cols
        return (u @ self.w_dt)[..., h0:h0 + nh]

    def out(self, y: torch.Tensor) -> torch.Tensor:
        out = y @ self.out_proj
        if self.reduce:
            return sharding.leave(out, self.seq)
        return sharding.to_span(out, self.seq)


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
              return_cache: bool = False, seq: bool = False):
    """u: (B, L, d_model) -> (out, final_state) or, with ``return_cache``,
    (out, (conv_cache (B, K-1, di+2n), ssd_state (B, nh, p, n))).
    ``seq``: ``u`` is this rank's span of the L positions, gathered on
    entry (the scan runs over every position), and ``out`` its span."""
    lp = _Local(params, cfg, seq)
    di, n, nh, p = lp.d_inner, cfg.ssm_state, lp.n_heads, cfg.ssm_head_dim
    if lp.partial:
        u = sharding.enter(u, seq)
    bsz, l, _ = u.shape
    z = u @ lp.w_z
    xr_raw = u @ lp.w_x
    Br_raw = u @ lp.w_B
    Cr_raw = u @ lp.w_C
    dt_raw = lp.dt_raw(u)
    xr = F.silu(_causal_conv(xr_raw, lp.conv_wx, lp.conv_bx))
    Bm = F.silu(_causal_conv(Br_raw, lp.conv_wB, lp.conv_bB))
    Cm = F.silu(_causal_conv(Cr_raw, lp.conv_wC, lp.conv_bC))
    xs = xr.reshape(bsz, l, nh, p)
    dt = F.softplus(dt_raw.float() + lp.dt_bias[None, None, :])
    A = -torch.exp(lp.A_log)
    scan = ssd_ops.ssd_scan
    if xs.device.type == "meta":           # shapes only: launch/costing.py
        scan = ssd_ops.ssd_scan_meta if kernels.ON_META else ssd_chunked
    y, state = scan(xs, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + xs * lp.D[None, None, :, None].to(y.dtype)
    y = y.reshape(bsz, l, di)
    y = _gated_norm(y, z, lp.norm_scale, cfg.norm_eps, cfg.d_inner)
    out = lp.out(y)
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

def local_heads(cfg: ModelConfig, params: Optional[Params] = None) -> int:
    """The SSD heads a rank holds: ``params`` (one layer's SSD leaves)
    split over ``model``, or every head."""
    if params is None:
        return cfg.ssm_n_heads
    _, nc = sharding.model_block(params["w_x"], 1, cfg.d_inner)
    return nc // cfg.ssm_head_dim


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   n_layers: Optional[int] = None,
                   device: Optional[torch.device] = None,
                   n_heads: Optional[int] = None) -> SSMState:
    """Zero conv ``(L, batch, K-1, nh * p + 2n)`` and SSD ``(L, batch,
    nh, p, n)`` caches for ``n_heads`` (the config's, or a rank's
    :func:`local_heads`)."""
    dt = dtype_of(cfg)
    L = n_layers if n_layers is not None else cfg.n_layers
    nh = n_heads or cfg.ssm_n_heads
    di, n = nh * cfg.ssm_head_dim, cfg.ssm_state
    return {
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dt, device=device),
        "ssd": torch.zeros((L, batch, nh, cfg.ssm_head_dim, n),
                           dtype=dt, device=device),
    }


def ssm_decode_step(params: Params, u: torch.Tensor, cfg: ModelConfig,
                    conv_state: torch.Tensor, ssd_state: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. u: (B, 1, d). conv_state: (B, K-1, di+2n);
    ssd_state: (B, nh, p, n). Returns (out, conv_state, ssd_state) as
    new tensors."""
    bsz = u.shape[0]
    lp = _Local(params, cfg)
    di, n, nh, p = lp.d_inner, cfg.ssm_state, lp.n_heads, cfg.ssm_head_dim
    ut = u[:, 0, :]
    z = ut @ lp.w_z
    xr = ut @ lp.w_x
    Br = ut @ lp.w_B
    Cr = ut @ lp.w_C
    dt_raw = lp.dt_raw(ut)

    new_in = torch.cat([xr, Br, Cr], dim=-1)              # (B, di+2n)
    window = torch.cat([conv_state, new_in[:, None, :]], dim=1)
    conv_w = torch.cat([lp.conv_wx, lp.conv_wB, lp.conv_wC], dim=-1)
    conv_b = torch.cat([lp.conv_bx, lp.conv_bB, lp.conv_bC], dim=-1)
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w.to(u.dtype))
    mixed = F.silu(conv_out + conv_b.to(u.dtype))
    new_conv_state = window[:, 1:, :]
    xs = mixed[..., :di].reshape(bsz, nh, p)
    Bm = mixed[..., di:di + n]
    Cm = mixed[..., di + n:]

    dt = F.softplus(dt_raw.float() + lp.dt_bias[None, :])
    A = -torch.exp(lp.A_log)
    dA = torch.exp(dt * A[None, :])                                 # (B, nh)
    upd = (dt[..., None] * xs.float())[..., :, None] \
        * Bm.float()[:, None, None, :]                              # (B,nh,p,n)
    state = dA[..., None, None] * ssd_state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + xs.float() * lp.D[None, :, None]
    y = y.reshape(bsz, di).to(u.dtype)
    y = _gated_norm(y, z, lp.norm_scale, cfg.norm_eps, cfg.d_inner)
    out = lp.out(y)[:, None, :]
    return (out, new_conv_state.to(conv_state.dtype),
            state.to(ssd_state.dtype))
