"""Evidence reactor — gossips byzantine-fault evidence (a copy of
cometbft_tpu/evidence/reactor.py; reference:
internal/evidence/reactor.go, channel 0x38 at reactor.go:17).

Per peer, one broadcast thread streams all pending evidence and then
waits for new arrivals; inbound evidence is verified by the pool
before being stored or re-gossiped.

``receive`` is the ``evidence_reactor`` trust-guard seam.  Where the
port departs from its reference: ``on_stop`` joins the broadcast threads
(bounded), so a stopped node leaves none behind.  ``receive`` keeps the
peer only for the benign refusals (expired, already committed) and
stops it for any other evidence error; an error that is not about the
evidence (a kernel that fails to build or launch in the light-client
attack check, a store's fault) propagates, where the reference logs it
at debug level and drops the evidence.  The connection's receive thread
then stops the peer with that error on record (``peer_error``).
"""

from __future__ import annotations

import threading

from cometbft_tpu_torch.evidence.pool import (
    EvidenceAlreadyCommittedError,
    EvidenceExpiredError,
    Pool,
)
from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.types import codec
from cometbft_tpu_torch.types.evidence import EvidenceError
from cometbft_tpu_torch.types.codec import as_bytes
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.protoio import ProtoReader, ProtoWriter
from cometbft_tpu_torch.utils import trustguard

EVIDENCE_CHANNEL = 0x38

_MAX_MSG_BYTES = 1048576


def encode_evidence_list(ev_list) -> bytes:
    w = ProtoWriter()
    for ev in ev_list:
        w.message(1, codec.encode_evidence(ev))
    return w.finish()


def decode_evidence_list(data: bytes):
    f = ProtoReader(data).to_dict()
    return [codec.decode_evidence(as_bytes(v)) for v in f.get(1, [])]


class EvidenceReactor(Reactor):
    """(internal/evidence/reactor.go:28 Reactor)"""

    def __init__(self, pool: Pool, logger: Logger | None = None):
        super().__init__(
            name="evidence-reactor",
            logger=logger
            or default_logger().with_fields(module="evidence-reactor"),
        )
        self.pool = pool
        self._threads_mtx = threading.Lock()
        self._threads: list[threading.Thread] = []

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(
                id=EVIDENCE_CHANNEL,
                priority=6,
                send_queue_capacity=10,
                recv_message_capacity=_MAX_MSG_BYTES,
            )
        ]

    def add_peer(self, peer) -> None:
        t = threading.Thread(
            target=self._broadcast_routine,
            args=(peer,),
            name=f"evidence-bcast-{peer.id[:8]}",
            daemon=True,
        )
        with self._threads_mtx:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def on_stop(self) -> None:
        with self._threads_mtx:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join(timeout=2.0)

    @trustguard.guarded_seam("evidence_reactor")
    def receive(self, env: Envelope) -> None:
        try:
            ev_list = decode_evidence_list(env.message)
        except Exception as exc:  # noqa: BLE001
            self.logger.error("malformed evidence msg", err=repr(exc))
            if self.switch is not None:
                self.switch.stop_peer_for_error(env.src, exc)
            return
        for ev in ev_list:
            try:
                self.pool.add_evidence(ev)
            except (EvidenceExpiredError, EvidenceAlreadyCommittedError) as exc:
                # benign timing or state skew; keep the peer
                self.logger.debug("rejected evidence", err=repr(exc))
            except EvidenceError as exc:
                # provably bad (EvidenceInvalidError, or the evidence's
                # own validate_basic): the sender is byzantine
                # (reactor.go:120)
                self.logger.info("invalid evidence from peer",
                                 err=repr(exc), peer=env.src.id[:10])
                if self.switch is not None:
                    self.switch.stop_peer_for_error(env.src, exc)
                return

    def _broadcast_routine(self, peer) -> None:
        """(reactor.go:83 broadcastEvidenceRoutine) — send everything
        pending, then follow new arrivals."""
        sent: set[bytes] = set()
        while (
            peer.is_running()
            and self.is_running()
            and not self._quit.is_set()
        ):
            pending, _ = self.pool.pending_evidence(-1)
            fresh = [ev for ev in pending if ev.hash() not in sent]
            if not fresh:
                self.pool.wait_for_evidence(timeout=0.5)
                continue
            if peer.send(EVIDENCE_CHANNEL, encode_evidence_list(fresh)):
                for ev in fresh:
                    sent.add(ev.hash())
            else:
                self._quit.wait(0.1)


__all__ = [
    "EvidenceReactor",
    "EVIDENCE_CHANNEL",
    "encode_evidence_list",
    "decode_evidence_list",
]
