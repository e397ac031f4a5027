"""Event-clock client-system layer for fault-tolerant async rounds.

The paper's deployment story is millions of intermittently-available
devices; :class:`repro.fed.simulator.FedSimulator` was a synchronous
barrier where every sampled client always answers.  This module is the
systems half of the async mode: a deterministic, *stateless* event
clock over (client, round) that decides availability, latency, and
fault injection — plus the admission queue the server drains every
tick and the CRC frame that makes wire corruption detectable.

Determinism contract
--------------------
Every draw is keyed by ``(seed, channel, client, round)`` through
``np.random.SeedSequence`` — no mutable RNG state anywhere.  Two
consequences the tests rely on:

* **replayable**: ``available(c, r)`` / ``dropout(c, r)`` /
  ``delay(c, r)`` / ``corrupt(c, r)`` return the same answer no matter
  when or how often they are called;
* **failure-invariant**: injecting a fault for client A cannot perturb
  any draw for client B (each (client, round) cell owns its own
  generator), which composes with the simulator's ``fold_in``-derived
  training keys into the end-to-end guarantee that survivors' local
  trajectories are bit-identical with and without the fault.

Fault model
-----------
:class:`FaultModel` covers the four failure classes of the async round
server (all probabilities per (client, round), all off by default so
``ClientSystems.ideal`` is the zero-fault trace):

* **dropout** — the sampled client trains but never uploads;
* **stragglers** — the upload lands ``straggler_delay`` rounds late
  (``straggler_delay=1`` models the "2x-latency" device that takes two
  round periods per round), on top of the per-client ``base_delay``
  heterogeneity vector;
* **crash-and-rejoin** — a crash at round q makes the client
  unavailable (never sampled) for rounds q .. q+crash_rounds−1, after
  which it rejoins with its last-served state;
* **corruption** — the client's *coded* upload stream is tampered on
  the wire: truncated at a random byte, or 1–8 distinct bit flips.

Wire framing
------------
Golomb-Rice streams are near-bijective — most bit flips decode to a
*different valid mask* — so corruption detection cannot live in the
entropy coder.  :func:`wrap_stream` adds a 9-byte frame (magic, uint32
payload length, CRC-32) and :func:`unwrap_stream` raises
:class:`WireFrameError` on any mismatch; together with the coder's own
:class:`~repro.fed.compression.CodedStreamError` validation this gives
the async strategy a validating decode that quarantines 100% of
injected truncations and bit flips.  Framing is only applied when the
fault model can corrupt (``corrupt_prob > 0``), so the zero-fault wire
— and therefore the measured bits in ``History`` — stays byte-identical
to the sync path (the sync ≡ async bit-parity anchor).
"""

from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

# the per-round fault/staleness/quarantine counters recorded in
# History.fault_counts — one dict per round, same keys in sync and
# async modes (sync rounds report sampled == admitted and zeros
# elsewhere)
FAULT_KEYS = ("sampled", "dropped", "crashed", "stragglers", "stale",
              "quarantined", "buffered", "admitted", "skipped")

FRAME_MAGIC = 0xA5
FRAME_BYTES = 9                     # magic(1) + length(4) + crc32(4)


def blank_fault_counters() -> Dict[str, int]:
    return {k: 0 for k in FAULT_KEYS}


class WireFrameError(ValueError):
    """A framed byte stream failed its length/CRC validation."""


def wrap_stream(stream: np.ndarray) -> np.ndarray:
    """Frame a uint8 stream: ``magic | uint32 length | uint32 crc32 |
    payload`` (little-endian).  The CRC covers the payload bytes; the
    explicit length makes truncation detection deterministic even when
    the cut lands on a self-delimiting record boundary."""
    payload = np.ascontiguousarray(np.asarray(stream, np.uint8).ravel())
    head = np.empty(FRAME_BYTES, np.uint8)
    head[0] = FRAME_MAGIC
    head[1:5] = np.array([payload.size], "<u4").view(np.uint8)
    head[5:9] = np.array([zlib.crc32(payload.tobytes())],
                         "<u4").view(np.uint8)
    return np.concatenate([head, payload])


def unwrap_stream(framed: np.ndarray) -> np.ndarray:
    """Validate and strip a :func:`wrap_stream` frame.  Raises
    :class:`WireFrameError` on a short/absent header, magic mismatch,
    length mismatch (truncated or trailing bytes), or CRC mismatch."""
    buf = np.ascontiguousarray(np.asarray(framed, np.uint8).ravel())
    if buf.size < FRAME_BYTES:
        raise WireFrameError(f"frame: {buf.size} bytes < {FRAME_BYTES}-byte "
                             "header")
    if int(buf[0]) != FRAME_MAGIC:
        raise WireFrameError(f"frame: bad magic {int(buf[0]):#x}")
    length = int(buf[1:5].view("<u4")[0])
    if buf.size - FRAME_BYTES != length:
        raise WireFrameError(f"frame: payload {buf.size - FRAME_BYTES} bytes"
                             f" != declared {length}")
    payload = buf[FRAME_BYTES:]
    crc = int(buf[5:9].view("<u4")[0])
    if zlib.crc32(payload.tobytes()) != crc:
        raise WireFrameError("frame: CRC mismatch")
    return payload


@dataclass(frozen=True)
class FaultModel:
    """Per-(client, round) fault probabilities (see module docstring).
    The default instance is the zero-fault model."""
    dropout: float = 0.0            # P(sampled client never uploads)
    straggler_frac: float = 0.0     # P(upload delayed straggler_delay)
    straggler_delay: int = 1        # extra rounds a straggler's upload takes
    crash_prob: float = 0.0         # P(crash at round r)
    crash_rounds: int = 2           # rounds unavailable after a crash
    corrupt_prob: float = 0.0       # P(coded upload tampered on the wire)
    truncate_frac: float = 0.5      # of corruptions: truncation vs bit flips
    seed: int = 0


# draw channels — one independent generator per (channel, client, round)
_CH_CRASH, _CH_DROP, _CH_DELAY, _CH_CORRUPT, _CH_TAMPER = range(5)


class ClientSystems:
    """Deterministic event-clock system model for ``n_clients`` devices.

    ``base_delay`` is the per-client latency heterogeneity vector (extra
    rounds every upload takes, before straggling); ``forced_dropouts``
    is a set of (client, round) pairs dropped with probability 1 —
    the regression-test hook for targeted fault injection."""

    def __init__(self, n_clients: int, faults: FaultModel = FaultModel(),
                 base_delay: Optional[Sequence[int]] = None,
                 forced_dropouts: Optional[set] = None):
        self.n_clients = int(n_clients)
        self.faults = faults
        self.base_delay = (np.zeros(self.n_clients, np.int64)
                           if base_delay is None
                           else np.asarray(base_delay, np.int64))
        if self.base_delay.shape != (self.n_clients,):
            raise ValueError("base_delay must have one entry per client")
        self.forced_dropouts = frozenset(forced_dropouts or ())

    @classmethod
    def ideal(cls, n_clients: int) -> "ClientSystems":
        """Always-available / zero-latency / zero-fault trace — the
        configuration under which async ≡ sync, bit for bit."""
        return cls(n_clients)

    # -- stateless draws ----------------------------------------------------
    def _rng(self, channel: int, client: int, rnd: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence((self.faults.seed, channel, client, rnd)))

    def _crashed_at(self, client: int, rnd: int) -> bool:
        if self.faults.crash_prob <= 0.0 or rnd < 0:
            return False
        return (self._rng(_CH_CRASH, client, rnd).random()
                < self.faults.crash_prob)

    def available(self, client: int, rnd: int) -> bool:
        """False while the client is crashed: a crash at round q covers
        rounds q .. q + crash_rounds − 1 (rejoin after)."""
        lo = max(0, rnd - self.faults.crash_rounds + 1)
        return not any(self._crashed_at(client, q)
                       for q in range(lo, rnd + 1))

    def dropout(self, client: int, rnd: int) -> bool:
        if (client, rnd) in self.forced_dropouts:
            return True
        if self.faults.dropout <= 0.0:
            return False
        return self._rng(_CH_DROP, client, rnd).random() < self.faults.dropout

    def is_straggler(self, client: int, rnd: int) -> bool:
        if self.faults.straggler_frac <= 0.0:
            return False
        return (self._rng(_CH_DELAY, client, rnd).random()
                < self.faults.straggler_frac)

    def delay(self, client: int, rnd: int) -> int:
        """Rounds until this round's upload reaches the server (0 =
        arrives within the dispatch round, the sync ideal)."""
        extra = (self.faults.straggler_delay
                 if self.is_straggler(client, rnd) else 0)
        return int(self.base_delay[client]) + extra

    def corrupt(self, client: int, rnd: int) -> bool:
        if self.faults.corrupt_prob <= 0.0:
            return False
        return (self._rng(_CH_CORRUPT, client, rnd).random()
                < self.faults.corrupt_prob)

    @property
    def injects_corruption(self) -> bool:
        """True when uploads must travel CRC-framed (corrupt_prob > 0);
        the zero-fault wire stays frameless for sync bit-parity."""
        return self.faults.corrupt_prob > 0.0

    def tamper(self, stream: np.ndarray, client: int, rnd: int) -> np.ndarray:
        """Deterministically corrupt a byte stream: truncate at a random
        byte (with prob ``truncate_frac``) or flip 1–8 DISTINCT bits
        (distinct so flips can never cancel back to the original)."""
        g = self._rng(_CH_TAMPER, client, rnd)
        s = np.array(stream, np.uint8, copy=True)
        if s.size == 0:
            return s
        if g.random() < self.faults.truncate_frac:
            return s[:int(g.integers(0, s.size))]
        n_flips = int(g.integers(1, 9))
        pos = g.choice(s.size * 8, size=min(n_flips, s.size * 8),
                       replace=False)
        np.bitwise_xor.at(s, pos // 8, (1 << (pos % 8)).astype(np.uint8))
        return s


@dataclass(order=True)
class _QueueItem:
    arrival: int
    dispatch: int
    seq: int
    payload: object = None


class AdmissionQueue:
    """Buffered upload admission: uploads land with their arrival tick,
    the server drains everything that has arrived by the current tick.

    Drain order is (arrival, dispatch round, push order) — so with an
    ideal trace (every arrival == dispatch == now, pushes in selection
    order) the drained order IS the sync round's upload order, which is
    what makes the async slot packing byte-identical to sync."""

    def __init__(self) -> None:
        self._heap: List[_QueueItem] = []
        self._seq = 0

    def push(self, arrival: int, dispatch: int, payload) -> None:
        heapq.heappush(self._heap,
                       _QueueItem(int(arrival), int(dispatch), self._seq,
                                  payload))
        self._seq += 1

    def pop_ready(self, now: int) -> List[_QueueItem]:
        out = []
        while self._heap and self._heap[0].arrival <= now:
            out.append(heapq.heappop(self._heap))
        return out

    def __len__(self) -> int:
        return len(self._heap)
