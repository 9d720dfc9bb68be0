"""WAN emulation at the MConnection frame pump (a copy of
cometbft_tpu/p2p/conn/netem.py).

Injects hostile-link conditions (latency, jitter, loss, bandwidth cap)
into the SEND side of every MConnection, at the seam where framed
packets hit the socket (``MConnection._flush``), with no root, no
``tc``, and no extra threads: the send routine itself sleeps the
injected wall inside a ``p2p/netem_hold`` span, so traces separate
*injected* wall from *intrinsic* wall.

Plan grammar — entries split on ``;``, each entry an optionally
windowed profile::

    delay=BASE~JITTER[@START-END]   propagation delay ms, +/- jitter ms
    delay=BASE[@START-END]          no jitter
    loss=P[@START-END]              loss probability in [0, 1)
    rate=BYTES[@START-END]          bandwidth cap, bytes/second
    seed=N                          RNG seed (jitter + loss draws)

Windows are seconds relative to the epoch the switch pins when it
starts (or at its first connection); an entry with no window is always
active.  Example — one cross-region link, 50 ms +/- 10 ms one way with
0.5 % of frames charged a retransmit: ``delay=50~10;loss=0.005;seed=7``.

Semantics:

- **Delay/jitter** hold the send routine before the socket write.
  Because MConnection frames are FIFO on one TCP stream, jitter never
  reorders (real netem can); the jitter draw is per-frame.
- **Loss** is TCP-faithful: the transport is a *reliable stream*, so
  a vanished frame would corrupt channel reassembly.  A loss draw
  instead charges the frame a retransmit penalty (one RTO:
  ``max(0.2 s, 2 x base delay)``) and increments
  ``netem_dropped_frames_total``.
- **Rate** is a leaky bucket: each frame reserves ``bytes/rate``
  seconds of link time behind the previous frame's reservation.
- The hold serializes on the send routine, emulating a link whose
  in-flight window is one frame.

Zero-cost off: with no plan, MConnection keeps ``_netem = None`` and
``_flush`` pays exactly one ``is None`` test per flush and writes the
same bytes.

Same seed => identical injected schedule: every stage draws from
``random.Random(f"{seed}:{peer_id}")``.

Where the port departs from its reference: the reference reads the
plan from ``CMT_TPU_NETEM`` into a process-wide singleton; the port
reads no environment variable.  The plan is an argument
(``Switch(netem=...)``, ``make_switch(netem=...)``), and the switch
hands each connection its stage.  ``NetemPlan.parse(text, source)``
names ``source`` in its errors (the reference names the variable).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from cometbft_tpu_torch.metrics import netem_metrics
from cometbft_tpu_torch.utils.trace import TRACER

__all__ = [
    "NetemError",
    "NetemPlan",
    "NetemStage",
]

#: TCP retransmit-timeout floor charged to a "lost" frame (RFC 6298
#: minimum RTO is 1 s; Linux's effective floor is 200 ms — we use the
#: observable Linux behaviour)
_RTO_MIN_S = 0.2


class NetemError(ValueError):
    """A malformed plan — always names where the plan came from."""


@dataclass(frozen=True)
class _Entry:
    kind: str  # delay | loss | rate
    p1: float  # delay: base ms | loss: probability | rate: bytes/sec
    p2: float  # delay: jitter ms | otherwise 0.0
    start: float  # window start, seconds from epoch
    end: float  # window end (inf = forever)

    def active(self, t: float) -> bool:
        return self.start <= t < self.end


def _parse_window(spec: str, raw: str, source: str) -> tuple[str, float, float]:
    """Split ``value[@A-B]`` -> (value, start, end)."""
    if "@" not in spec:
        return spec, 0.0, float("inf")
    val, _, win = spec.partition("@")
    a, sep, b = win.partition("-")
    if not sep:
        raise NetemError(
            f"{source}: window {win!r} in {raw!r} must be START-END seconds"
        )
    try:
        lo, hi = float(a), float(b)
    except ValueError:
        raise NetemError(
            f"{source}: non-numeric window {win!r} in {raw!r}"
        ) from None
    if lo < 0 or hi <= lo:
        raise NetemError(
            f"{source}: window {win!r} in {raw!r} needs 0 <= START < END"
        )
    return val, lo, hi


@dataclass(frozen=True)
class NetemPlan:
    """Parsed, validated emulation plan (immutable after parse)."""

    entries: tuple[_Entry, ...]
    seed: int

    @classmethod
    def parse(cls, text: str, source: str = "netem plan") -> "NetemPlan":
        entries: list[_Entry] = []
        seed = 0
        for raw in text.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            kind, sep, spec = raw.partition("=")
            kind = kind.strip()
            if not sep or not spec.strip():
                raise NetemError(
                    f"{source}: entry {raw!r} must be kind=value"
                )
            spec = spec.strip()
            if kind == "seed":
                try:
                    seed = int(spec)
                except ValueError:
                    raise NetemError(
                        f"{source}: seed {spec!r} must be an integer"
                    ) from None
                continue
            if kind not in ("delay", "loss", "rate"):
                raise NetemError(
                    f"{source}: unknown kind {kind!r} in {raw!r} "
                    "(want delay|loss|rate|seed)"
                )
            val, lo, hi = _parse_window(spec, raw, source)
            if kind == "delay":
                base_s, _, jit_s = val.partition("~")
                try:
                    base = float(base_s)
                    jitter = float(jit_s) if jit_s else 0.0
                except ValueError:
                    raise NetemError(
                        f"{source}: delay {val!r} must be BASE[~JITTER] ms"
                    ) from None
                if base < 0 or jitter < 0:
                    raise NetemError(
                        f"{source}: delay {val!r} must be >= 0 ms"
                    )
                entries.append(_Entry("delay", base, jitter, lo, hi))
            elif kind == "loss":
                try:
                    p = float(val)
                except ValueError:
                    raise NetemError(
                        f"{source}: loss {val!r} must be a probability"
                    ) from None
                if not 0.0 <= p < 1.0:
                    raise NetemError(
                        f"{source}: loss {val!r} must be in [0, 1)"
                    )
                entries.append(_Entry("loss", p, 0.0, lo, hi))
            else:  # rate
                try:
                    r = float(val)
                except ValueError:
                    raise NetemError(
                        f"{source}: rate {val!r} must be bytes/second"
                    ) from None
                if r <= 0:
                    raise NetemError(
                        f"{source}: rate {val!r} must be > 0 bytes/second"
                    )
                entries.append(_Entry("rate", r, 0.0, lo, hi))
        if not entries:
            raise NetemError(
                f"{source}: plan {text!r} has no delay/loss/rate entries"
            )
        return cls(entries=tuple(entries), seed=seed)

    def params_at(
        self, t: float
    ) -> tuple[float, float, float, float, int]:
        """(delay_ms, jitter_ms, loss_p, rate_bps, active_count) at
        plan-relative time ``t`` (later entries of a kind win, like
        the chaos grammar's fault windows)."""
        delay = jitter = loss = 0.0
        rate = 0.0  # 0 = uncapped
        n = 0
        for e in self.entries:
            if not e.active(t):
                continue
            n += 1
            if e.kind == "delay":
                delay, jitter = e.p1, e.p2
            elif e.kind == "loss":
                loss = e.p1
            else:
                rate = e.p1
        return delay, jitter, loss, rate, n

    def describe(self) -> str:
        parts = [f"seed={self.seed}"]
        for e in self.entries:
            win = (
                ""
                if e.end == float("inf") and e.start == 0.0
                else f"@{e.start:g}-{e.end:g}"
            )
            if e.kind == "delay":
                parts.append(f"delay={e.p1:g}~{e.p2:g}ms{win}")
            elif e.kind == "loss":
                parts.append(f"loss={e.p1:g}{win}")
            else:
                parts.append(f"rate={e.p1:g}B/s{win}")
        return ";".join(parts)


class NetemStage:
    """Per-peer send-side emulation stage.  Owned by exactly one
    MConnection send routine — ``hold()`` runs in (and sleeps) that
    thread, which is the whole point: the hold IS the link."""

    def __init__(self, plan: NetemPlan, peer_id: str, epoch: float):
        self._plan = plan
        self._peer = peer_id or "?"
        self._epoch = epoch
        # seeded per (plan seed, peer): same seed => same schedule
        self._rng = random.Random(f"{plan.seed}:{self._peer}")
        self._link_free_at = 0.0  # leaky-bucket reservation (monotonic)
        #: this link's totals (a caller reads them per connection; the
        #: metric children are per peer id only)
        self.frames = 0
        self.dropped = 0
        self.injected_s = 0.0
        m = netem_metrics()
        self._m_delay = m.injected_delay_seconds.labels(
            peer_id=self._peer
        )
        self._m_dropped = m.dropped_frames_total.labels(
            peer_id=self._peer
        )
        self._m_profile = m.active_profile.labels(peer_id=self._peer)

    def hold_s(self, nbytes: int, now: float) -> tuple[float, bool]:
        """Pure schedule: injected seconds for an ``nbytes`` frame
        sent at monotonic ``now``, plus whether the loss draw fired.
        Split from :meth:`hold` so determinism is testable without
        sleeping."""
        t = now - self._epoch
        delay_ms, jitter_ms, loss_p, rate, n = self._plan.params_at(t)
        self._m_profile.set(float(n))
        if n == 0:
            return 0.0, False
        h = delay_ms / 1e3
        if jitter_ms:
            h += self._rng.uniform(-jitter_ms, jitter_ms) / 1e3
        lost = loss_p > 0.0 and self._rng.random() < loss_p
        if lost:
            # retransmit penalty, not a vanished frame (module doc)
            h += max(_RTO_MIN_S, 2.0 * delay_ms / 1e3)
        if rate > 0.0:
            busy_until = max(self._link_free_at, now)
            self._link_free_at = busy_until + nbytes / rate
            h += self._link_free_at - now
        return max(h, 0.0), lost

    def hold(self, nbytes: int) -> None:
        """Sleep the injected wall for one frame, inside the
        ``p2p/netem_hold`` span the stitched trace separates from
        intrinsic gossip wall."""
        h, lost = self.hold_s(nbytes, time.monotonic())
        self.frames += 1
        if lost:
            self.dropped += 1
            self._m_dropped.inc()
        if h <= 0.0:
            return
        self.injected_s += h
        with TRACER.span(
            "p2p/netem_hold", cat="p2p", peer=self._peer,
            bytes=nbytes, lost=int(lost),
        ):
            time.sleep(h)
        self._m_delay.observe(h)

    def retire(self) -> None:
        """Peer departed: drop the per-peer metric children so the
        exposition stops carrying a dead link (P2PMetrics idiom)."""
        m = netem_metrics()
        m.injected_delay_seconds.remove(peer_id=self._peer)
        m.dropped_frames_total.remove(peer_id=self._peer)
        m.active_profile.remove(peer_id=self._peer)
