"""Reactor interface (a copy of cometbft_tpu/p2p/base_reactor.py;
reference: p2p/base_reactor.go:15).

A Reactor owns a set of channels on every peer connection and receives
envelopes from the switch's per-connection recv thread.  Lifecycle:
``set_switch`` → ``start`` → ``init_peer``/``add_peer``/``remove_peer``
per peer → ``receive`` per message.
"""

from __future__ import annotations

from dataclasses import dataclass

from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor
from cometbft_tpu_torch.utils.service import BaseService


@dataclass(frozen=True)
class Envelope:
    """(p2p/peer.go Envelope) — a routed inbound message."""

    channel_id: int
    src: object  # Peer
    message: bytes


class Reactor(BaseService):
    """(p2p/base_reactor.go:15 Reactor / :83 BaseReactor)"""

    def __init__(self, name: str, **kw):
        super().__init__(name=name, **kw)
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> list[ChannelDescriptor]:
        raise NotImplementedError

    def init_peer(self, peer) -> object:
        """Called before the peer starts; may mutate/annotate the peer."""
        return peer

    def add_peer(self, peer) -> None:
        """Called after the peer is started and added to the peer set."""

    def remove_peer(self, peer, reason: object = None) -> None:
        pass

    def receive(self, envelope: Envelope) -> None:
        pass


__all__ = ["Reactor", "Envelope"]
