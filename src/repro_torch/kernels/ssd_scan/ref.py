"""Oracle for the SSD scan: the naive O(L) sequential recurrence, the
JAX package's ``kernels/ssd_scan/ref.py``.

    state_t = exp(dt_t * A) * state_{t-1} + dt_t * x_t (outer) B_t
    y_t     = state_t @ C_t

Independent of the chunked algorithm (``models/ssm.py::ssd_chunked``,
the kernel's plain version) and of the CUDA kernel, so it validates both.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor,
            init_state: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); dt: (b, l, h) post-softplus; A: (h,) negative;
    B, C: (b, l, n). Returns (y (b, l, h, p), state (b, h, p, n))."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    x32, dt32, B32, C32 = x.float(), dt.float(), B.float(), C.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        dA = torch.exp(dt32[:, t] * A[None, :])                   # (b, h)
        upd = (dt32[:, t, :, None] * x32[:, t])[..., None] \
            * B32[:, t, None, None, :]
        state = dA[..., None, None] * state + upd                # (b, h, p, n)
        ys.append(torch.einsum("bhpn,bn->bhp", state, C32[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                       # (b, l, h, p)
    return y, state.to(x.dtype)


def ssd_priors_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   ) -> torch.Tensor:
    """The state entering each chunk of the chunked scan (chunk clamped to
    l), ``(b, h, nc, p, n)`` rounded to x's dtype: what the forward kernel
    writes for the backward (``kernel.launch(..., with_priors=True)``),
    from ``ssd_chunked``'s recurrence with its rounding points."""
    b, l, h, p = x.shape
    chunk = min(chunk, l)
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32
    pad = (-l) % chunk
    nc = (l + pad) // chunk

    def chunks(t: torch.Tensor) -> torch.Tensor:
        t = torch.nn.functional.pad(t.to(wt), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(b, nc, chunk, *t.shape[2:])

    dtc = chunks(dt[..., None])[..., 0]               # (b, nc, q, h)
    seg = torch.cumsum(dtc * A.to(wt), dim=2)
    seg_last = seg[:, :, -1]                          # (b, nc, h)
    w = (dtc * torch.exp(seg_last[:, :, None] - seg)).to(x.dtype).to(wt)
    wx = (chunks(x) * w[..., None]).to(x.dtype).to(wt)
    S = torch.einsum("bcqn,bcqhp->bchpn", chunks(B), wx)
    state = (torch.zeros((b, h, p, B.shape[-1]), dtype=wt, device=x.device)
             if init_state is None else init_state.to(wt))
    pr = []
    for c in range(nc):
        pr.append(state)
        state = torch.exp(seg_last[:, c, :, None, None]) * state + S[:, c]
    return torch.stack(pr, dim=2).to(x.dtype)


def reverse_walk(decay: torch.Tensor, U: torch.Tensor,
                 dstate: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward's serial part: ``dS_{c-1} = decay_c dS_c + U_c`` from
    ``dS_{nc-1} = dstate``. decay ``(b, nc, h)`` is exp(seg_last), U
    ``(b, nc, h, p, n)`` each chunk's ``sum_q dy_q^T Cd_q``. Returns every
    ``dS_c`` ``(b, nc, h, p, n)`` and the gradient of the state entering
    chunk 0."""
    cur = dstate
    dS = [None] * U.shape[1]
    for c in range(U.shape[1] - 1, -1, -1):
        dS[c] = cur
        cur = decay[:, c, :, None, None] * cur + U[:, c]
    return torch.stack(dS, dim=1), cur


def seg_to_ddA(dseg: torch.Tensor, dlast: torch.Tensor) -> torch.Tensor:
    """``d(dt A)`` ``(b, nc, q, h)`` from dseg: each chunk's seg_last
    gradient ``dlast`` ``(b, nc, h)`` joins its last position (padded in
    a ragged tail chunk, so it still reaches the real positions before
    it), then the within-chunk reverse cumsum."""
    dseg = dseg.clone()
    dseg[:, :, -1] += dlast
    return torch.flip(torch.cumsum(torch.flip(dseg, [2]), dim=2), [2])


def ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                dy: torch.Tensor, dstate: Optional[torch.Tensor] = None,
                init_state: Optional[torch.Tensor] = None,
                priors: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, ...]:
    """The gradient of the chunked scan (``models/ssm.py::ssd_chunked``,
    chunk clamped to l as the kernels clamp it) from the backward
    kernel's formulas in plain torch, f32 throughout (f64 for f64 x):
    ``(dx, ddt, dA, dB, dC, dinit)`` in the inputs' dtypes, ``dinit``
    None without ``init_state``. ``dy`` is y's gradient, ``dstate`` the
    final state's (None: unused). ``priors`` are the states entering each
    chunk as the forward kernel writes them, ``(b, h, nc, p, w)`` with
    ``w >= n`` (the first n columns read); None recomputes them.

    Per (b, h) and chunk, with ``seg`` the within-chunk cumsum of
    ``dt A``, ``G_qk = C_q . B_k``, ``dec_qk = exp(seg_q - seg_k)`` for
    k <= q (a select), ``att = G dec dt_k``, ``Cd_q = C_q exp(seg_q)``,
    ``w_k = dt_k exp(seg_last - seg_k)``, ``wx_k = x_k w_k``, and
    ``dS_c`` the gradient of the state leaving chunk c:

    * the reverse walk ``dS_{c-1} = exp(seg_last_c) dS_c + sum_q dy_q^T
      Cd_q``, whose last value is ``dinit``;
    * ``dP_qk = dy_q . x_k``; ``dx_k = sum_q att_qk dy_q + w_k dS_c B_k``;
      ``dG = dP dec dt_k`` gives ``dC = dG B + (dy prior) exp(seg)`` and
      ``dB = dG^T C + wx dS_c``, summed over the heads;
    * ``ddt_k`` directly from ``att`` and ``w``; ``dseg`` from ``att``,
      ``Cd``, ``w`` and the chunk decay, its within-chunk reverse cumsum
      giving ``d(dt A)``, so ``ddt += A d(dt A)`` and ``dA = sum dt
      d(dt A)``.

    att, ``x w``, ``Cd`` and the prior are rounded to x's dtype where the
    plain version rounds them (bf16)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    wt = torch.float64 if x.dtype == torch.float64 else torch.float32

    def rd(t: torch.Tensor) -> torch.Tensor:
        return t.to(x.dtype).to(wt)

    pad = (-l) % chunk
    L = l + pad
    nc, q = L // chunk, chunk

    def chunks(t: torch.Tensor) -> torch.Tensor:
        t = torch.nn.functional.pad(t.to(wt), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(b, nc, q, *t.shape[2:])

    xc, dyc = chunks(x), chunks(dy)                   # (b, nc, q, h, p)
    dtc = chunks(dt[..., None])[..., 0]               # (b, nc, q, h)
    Bc, Cc = chunks(B), chunks(C)                     # (b, nc, q, n)
    Af = A.to(wt)
    seg = torch.cumsum(dtc * Af, dim=2)
    seg_last = seg[:, :, -1]                          # (b, nc, h)
    decay = torch.exp(seg_last)
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    ii = torch.arange(q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    dec = torch.where(tri, torch.exp(seg[:, :, :, None] - seg[:, :, None]),
                      0.0)                            # (b, nc, q, k, h)
    attf = G[..., None] * dec * dtc[:, :, None]
    e_seg = torch.exp(seg)
    Cd = rd(Cc[:, :, :, None, :] * e_seg[..., None])  # (b, nc, q, h, n)
    e_end = torch.exp(seg_last[:, :, None] - seg)
    wf = dtc * e_end
    w = rd(wf)
    if priors is None:
        priors = ssd_priors_ref(x, dt, A, B, C, chunk, init_state)
    prior = priors[..., :n].to(wt).permute(0, 2, 1, 3, 4)  # (b, nc, h, p, n)

    # the reverse walk over the chunks
    U = torch.einsum("bcqhp,bcqhn->bchpn", dyc, Cd)
    dSc, cur = reverse_walk(
        decay, U, torch.zeros((b, h, p, n), dtype=wt, device=x.device)
        if dstate is None else dstate.to(wt))         # (b, nc, h, p, n)

    # intra-chunk terms
    dP = torch.where(tri, torch.einsum("bcqhp,bckhp->bcqkh", dyc, xc), 0.0)
    dx = torch.einsum("bcqkh,bcqhp->bckhp", rd(attf), dyc)
    dG = dP * dec * dtc[:, :, None]
    ddt = (dP * G[..., None] * dec).sum(dim=2)        # (b, nc, k, h)
    dpa = dP * attf
    dseg = dpa.sum(dim=3) - dpa.sum(dim=2)            # (b, nc, q, h)
    dC = torch.einsum("bcqkh,bckn->bcqn", dG, Bc)
    dB = torch.einsum("bcqkh,bcqn->bckn", dG, Cc)
    # the inter-chunk term y += Cd . prior^T
    dCd = torch.einsum("bcqhp,bchpn->bcqhn", dyc, prior)
    dC = dC + torch.einsum("bcqhn,bcqh->bcqn", dCd, e_seg)
    dseg = dseg + (dCd * Cc[:, :, :, None, :]).sum(dim=-1) * e_seg
    # the state leaving the chunk: exp(seg_last) prior + sum_k wx_k^T B_k
    dwx = torch.einsum("bchpn,bckn->bckhp", dSc, Bc)
    dx = dx + dwx * w[..., None]
    dB = dB + torch.einsum("bchpn,bckhp->bckn", dSc, rd(xc * w[..., None]))
    dw = (dwx * xc).sum(dim=-1)                       # (b, nc, k, h)
    ddt = ddt + dw * e_end
    dseg = dseg - dw * wf
    dlast = (dw * wf).sum(dim=2) + decay * (dSc * prior).sum(dim=(-1, -2))
    ddA = seg_to_ddA(dseg, dlast)
    ddt = ddt + ddA * Af
    dA = (ddA * dtc).sum(dim=(0, 1, 2))

    def unchunk(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, L, *t.shape[3:])[:, :l]

    dinit = None if init_state is None else cur.to(init_state.dtype)
    return (unchunk(dx).to(x.dtype), unchunk(ddt).to(dt.dtype),
            dA.to(A.dtype), unchunk(dB).to(B.dtype), unchunk(dC).to(C.dtype),
            dinit)
