"""The ReCXL Logging Unit (paper SS IV.B-C) as a state machine on tensors.

Each node owns one unit:

* an **SRAM Log Buffer** (small, fixed-capacity): entries are *allocated*
  on REPL reception and *validated* on VAL reception (possibly out of
  order -- the CXL fabric reorders messages);
* a **DRAM log** (large, append-only): validated entries drain from SRAM
  to DRAM strictly in per-source logical-timestamp order, so the DRAM log
  order equals program order (SS IV.C) even under fabric reordering. The
  timestamp is stripped on the way (paper: "As entries are pushed into the
  DRAM log, the timestamp is stripped-out"; it is kept in a side tensor
  purely for test assertions);
* per-source ``next_ts`` counters enforcing the in-order drain.

All operations are pure functions on a :class:`LogUnitState` NamedTuple
of tensors, as in the JAX package: they return a new state and leave
their input as it was. Branches stay on the device -- ``torch.where``
selects between the taken and the untaken result, with no ``.item()`` --
so a sequence of operations never waits for the card. ``argmax`` /
``argmin`` run on int32 (not bool) and return the first index on ties,
as ``jnp.argmax`` / ``jnp.argmin`` do. Values are fixed-width vectors
(``value_width`` words).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import resolve_device

EMPTY = -1
_I32 = torch.int32
_I32_MAX = torch.iinfo(torch.int32).max


class LogUnitState(NamedTuple):
    # --- SRAM Log Buffer ---
    sram_src: torch.Tensor     # (S,) int32 source node, -1 = free
    sram_addr: torch.Tensor    # (S,) int32 word/row address
    sram_val: torch.Tensor     # (S, W) float32 logged values
    sram_ts: torch.Tensor      # (S,) int32 logical TS (-1 until VAL)
    sram_valid: torch.Tensor   # (S,) bool
    sram_seq: torch.Tensor     # (S,) int32 allocation order (VAL matching)
    alloc_seq: torch.Tensor    # () int32 global allocation counter
    # --- DRAM log (append-only ring) ---
    dram_src: torch.Tensor     # (D,) int32
    dram_addr: torch.Tensor    # (D,) int32
    dram_val: torch.Tensor     # (D, W) float32
    dram_ts: torch.Tensor      # (D,) int32 (kept for assertions only)
    dram_ptr: torch.Tensor     # () int32 append cursor
    # --- ordering ---
    next_ts: torch.Tensor      # (n_sources,) int32 next TS to drain per src
    dropped: torch.Tensor      # () int32 count of REPLs dropped (SRAM full)


def init_state(sram_entries: int, dram_entries: int, n_sources: int,
               value_width: int = 1, device=None) -> LogUnitState:
    """An empty unit on ``device`` (``None`` means CUDA, and raises
    without a card)."""
    dev = resolve_device(device)

    def full(shape, fill, dtype=_I32):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    return LogUnitState(
        sram_src=full((sram_entries,), EMPTY),
        sram_addr=full((sram_entries,), EMPTY),
        sram_val=full((sram_entries, value_width), 0.0, torch.float32),
        sram_ts=full((sram_entries,), EMPTY),
        sram_valid=full((sram_entries,), False, torch.bool),
        sram_seq=full((sram_entries,), 0),
        alloc_seq=full((), 0),
        dram_src=full((dram_entries,), EMPTY),
        dram_addr=full((dram_entries,), EMPTY),
        dram_val=full((dram_entries, value_width), 0.0, torch.float32),
        dram_ts=full((dram_entries,), EMPTY),
        dram_ptr=full((), 0),
        next_ts=full((n_sources,), 0),
        dropped=full((), 0),
    )


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_I32, device=like.device)


def _set(t: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``t.at[idx].set(value)``: a copy of ``t`` with row ``idx``
    replaced (``idx`` a 0-d index tensor)."""
    value = torch.as_tensor(value, dtype=t.dtype, device=t.device)
    return t.index_put((idx.reshape(1).long(),),
                       value.reshape((1,) + t.shape[1:]))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax(mask)``: the first True index (0 when none)."""
    return torch.argmax(mask.to(_I32))


# ---------------------------------------------------------------------------
# REPL reception: allocate an SRAM entry
# ---------------------------------------------------------------------------

def receive_repl(state: LogUnitState, src, addr, value) -> LogUnitState:
    """Allocate one SRAM entry for (src, addr, value).

    Each REPL gets its *own* entry (two same-address stores can be in
    flight under ReCXL-proactive; store coalescing happens in the SB
    before REPLs are sent, never inside the Logging Unit). If SRAM is
    full the REPL is counted as dropped (hardware would NACK + retry)."""
    s = state
    free = s.sram_src == EMPTY
    has_free = free.any()
    slot = _first_true(free)
    written = s._replace(
        sram_src=_set(s.sram_src, slot, _i32(src, s.sram_src)),
        sram_addr=_set(s.sram_addr, slot, _i32(addr, s.sram_addr)),
        sram_val=_set(s.sram_val, slot, value),
        sram_ts=_set(s.sram_ts, slot, EMPTY),
        sram_valid=_set(s.sram_valid, slot, False),
        sram_seq=_set(s.sram_seq, slot, s.alloc_seq),
        alloc_seq=s.alloc_seq + 1,
    )
    dropped = s._replace(dropped=s.dropped + 1)
    return LogUnitState(*(torch.where(has_free, a, b)
                          for a, b in zip(written, dropped)))


# ---------------------------------------------------------------------------
# VAL reception: validate + stamp
# ---------------------------------------------------------------------------

def receive_val(state: LogUnitState, src, addr, ts) -> LogUnitState:
    """Mark the *oldest unvalidated* (src, addr) entry valid and record its
    logical timestamp.

    VALs from different sources / for different addresses can arrive in
    any order (the fabric reorders; draining enforces TS order). Matching
    assumes same-(src, addr) REPLs and VALs are point-to-point ordered."""
    match = ((state.sram_src == _i32(src, state.sram_src))
             & (state.sram_addr == _i32(addr, state.sram_addr))
             & ~state.sram_valid)
    has = match.any()
    seq = torch.where(match, state.sram_seq, _i32(_I32_MAX, state.sram_seq))
    slot = torch.argmin(seq)
    return state._replace(
        sram_ts=torch.where(has, _set(state.sram_ts, slot,
                                      _i32(ts, state.sram_ts)),
                            state.sram_ts),
        sram_valid=torch.where(has, _set(state.sram_valid, slot, True),
                               state.sram_valid),
    )


# ---------------------------------------------------------------------------
# SRAM -> DRAM drain (in per-source TS order)
# ---------------------------------------------------------------------------

def _drain_one(state: LogUnitState) -> Tuple[LogUnitState, torch.Tensor]:
    """Move at most one eligible entry (valid and ts == next_ts[src])."""
    s = state
    src_safe = torch.clamp(s.sram_src, min=0).long()
    eligible = (s.sram_valid
                & (s.sram_src != EMPTY)
                & (s.sram_ts == s.next_ts[src_safe]))
    has = eligible.any()
    slot = _first_true(eligible)
    d = torch.remainder(s.dram_ptr, s.dram_src.shape[0])
    src = s.sram_src[slot]
    src_c = torch.clamp(src, min=0)   # only the untaken branch sees -1
    moved = s._replace(
        dram_src=_set(s.dram_src, d, src),
        dram_addr=_set(s.dram_addr, d, s.sram_addr[slot]),
        dram_val=_set(s.dram_val, d, s.sram_val[slot]),
        dram_ts=_set(s.dram_ts, d, s.sram_ts[slot]),
        dram_ptr=s.dram_ptr + 1,
        next_ts=_set(s.next_ts, src_c, s.next_ts[src_c.long()] + 1),
        sram_src=_set(s.sram_src, slot, EMPTY),
        sram_ts=_set(s.sram_ts, slot, EMPTY),
        sram_valid=_set(s.sram_valid, slot, False),
    )
    return LogUnitState(*(torch.where(has, a, b)
                          for a, b in zip(moved, s))), has


def drain(state: LogUnitState, max_moves: int) -> LogUnitState:
    """Drain up to ``max_moves`` entries (background SRAM->DRAM mover)."""
    for _ in range(max_moves):
        state, _moved = _drain_one(state)
    return state


# ---------------------------------------------------------------------------
# Queries (recovery + tests)
# ---------------------------------------------------------------------------

def latest_version(state: LogUnitState, src, addr
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Algorithm 2 for one address: newest logged value for (src, addr),
    searching DRAM (newest = highest ts) and the *validated* SRAM entries
    not yet drained (unvalidated ones are not committed). Returns
    (found, ts, value)."""
    src = _i32(src, state.dram_src)
    addr = _i32(addr, state.dram_src)
    m = (state.dram_src == src) & (state.dram_addr == addr)
    found = m.any()
    ts = torch.where(m, state.dram_ts, _i32(-1, state.dram_ts))
    best = torch.argmax(ts)
    ms = (state.sram_src == src) & (state.sram_addr == addr) \
        & state.sram_valid
    found_s = ms.any()
    ts_s = torch.where(ms, state.sram_ts, _i32(-1, state.sram_ts))
    best_s = torch.argmax(ts_s)
    use_sram = found_s & (ts_s[best_s] > torch.where(found, ts[best],
                                                     _i32(-1, ts)))
    out_ts = torch.where(use_sram, ts_s[best_s], ts[best])
    out_val = torch.where(use_sram, state.sram_val[best_s],
                          state.dram_val[best])
    return found | found_s, out_ts, out_val


def occupancy(state: LogUnitState) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sram_used, dram_used) -- Fig. 13 instrumentation."""
    return ((state.sram_src != EMPTY).sum(),
            torch.clamp(state.dram_ptr, max=state.dram_src.shape[0]))


def clear_dram(state: LogUnitState) -> LogUnitState:
    """Post-dump log clear (paper SS IV.E)."""
    return state._replace(
        dram_src=torch.full_like(state.dram_src, EMPTY),
        dram_addr=torch.full_like(state.dram_addr, EMPTY),
        dram_ts=torch.full_like(state.dram_ts, EMPTY),
        dram_ptr=torch.zeros_like(state.dram_ptr),
    )
