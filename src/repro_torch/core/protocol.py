"""ReCXL protocol messages (paper Figures 4-5 and Table I).

These dataclasses are the *control-plane* representation, used by the
fine-grained Logging Unit, the recovery orchestrator, and the protocol
simulator. The data-plane (training replication engine) encodes the same
information as packed device arrays for jit-compatibility.

Bit-widths follow the paper exactly; ``wire_bits`` methods are used by the
bandwidth benchmarks (Fig. 14/16).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class MsgType(enum.Enum):
    REPL = "REPL"
    REPL_ACK = "REPL_ACK"
    VAL = "VAL"
    # recovery control plane (Table I)
    INTERRUPT = "Interrupt"
    INTERRUPT_RESP = "InterruptResp"
    INIT_RECOV = "InitRecov"
    FETCH_LATEST_VERS = "FetchLatestVers"
    FETCH_LATEST_VERS_RESP = "FetchLatestVersResp"
    INIT_RECOV_RESP = "InitRecovResp"
    RECOV_END = "RecovEnd"
    RECOV_END_RESP = "RecovEndResp"


# --- field widths from Fig. 4/5 (bits) --------------------------------------
REQUESTER_ID_BITS = 10          # {CN, core}
WORD_MASK_BITS = 16             # words per 64B line (word = 4B)
LINE_ADDR_BITS = 44
WORD_ADDR_BITS = 46
WORD_VALUE_BITS = 32
LOGICAL_TS_BITS = 7
VALID_BITS = 1
WORDS_PER_LINE = 16


@dataclass(frozen=True)
class ReplMsg:
    """REPL (Fig. 4a): replicate one (possibly coalesced) line update."""
    requester_cn: int
    requester_core: int
    line_addr: int
    word_mask: int                        # bit i set => word i updated
    word_values: Tuple[int, ...]          # len == popcount(word_mask)

    def __post_init__(self) -> None:
        n = bin(self.word_mask).count("1")
        if n != len(self.word_values):
            raise ValueError(
                f"word_mask has {n} set bits but {len(self.word_values)} values")
        if not 0 < n <= WORDS_PER_LINE:
            raise ValueError("REPL must carry 1..16 words")

    @property
    def requester_id(self) -> Tuple[int, int]:
        return (self.requester_cn, self.requester_core)

    def wire_bits(self) -> int:
        return (REQUESTER_ID_BITS + WORD_MASK_BITS + LINE_ADDR_BITS
                + WORD_VALUE_BITS * len(self.word_values))

    def split_words(self) -> List[Tuple[int, int]]:
        """(word_addr, value) pairs -- one log entry each (paper SS IV.B)."""
        out, vi = [], 0
        for w in range(WORDS_PER_LINE):
            if self.word_mask >> w & 1:
                out.append((self.line_addr * WORDS_PER_LINE + w,
                            self.word_values[vi]))
                vi += 1
        return out


@dataclass(frozen=True)
class ReplAckMsg:
    replica_cn: int
    requester_cn: int
    requester_core: int
    line_addr: int

    def wire_bits(self) -> int:
        return REQUESTER_ID_BITS + LINE_ADDR_BITS


@dataclass(frozen=True)
class ValMsg:
    """VAL (Fig. 4b): all replicas updated; carries the logical TS."""
    requester_cn: int
    requester_core: int
    logical_ts: int
    line_addr: int

    def wire_bits(self) -> int:
        return REQUESTER_ID_BITS + LOGICAL_TS_BITS + LINE_ADDR_BITS


@dataclass(frozen=True)
class LogEntry:
    """Fig. 5: one store's worth of logged state."""
    requester_cn: int
    requester_core: int
    logical_ts: int
    word_addr: int
    value: int
    valid: bool = False

    def wire_bits(self) -> int:
        return (REQUESTER_ID_BITS + LOGICAL_TS_BITS + WORD_ADDR_BITS
                + WORD_VALUE_BITS + VALID_BITS)


# --- recovery control plane (Table I) ---------------------------------------

@dataclass(frozen=True)
class FetchLatestVers:
    addrs: Tuple[int, ...]                # line addrs owned by the failed CN


@dataclass(frozen=True)
class FetchLatestVersResp:
    replica_cn: int
    # addr -> versions, sorted latest-to-earliest (Algorithm 2)
    versions: Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]


@dataclass(frozen=True)
class RecoveryStats:
    """Bookkeeping the benchmarks read (Fig. 15 analogue)."""
    failed_node: int
    shared_entries_cleared: int
    owned_entries: int
    recovered_from_replicas: int
    recovered_from_mn_dump: int
    unrecoverable: int = 0
