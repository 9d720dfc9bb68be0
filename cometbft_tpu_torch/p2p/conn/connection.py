"""Channel descriptors (a part of cometbft_tpu/p2p/conn/connection.py;
reference: p2p/conn/connection.go:612).

Only ``ChannelDescriptor`` is ported: a reactor names its channels with
it.  ``MConnection``, its packets and flow control come with the wire.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChannelDescriptor:
    """(connection.go:612 ChannelDescriptor)"""

    id: int
    priority: int = 1
    send_queue_capacity: int = 64
    recv_message_capacity: int = 22020096  # 21MB (consensus max msg)


__all__ = ["ChannelDescriptor"]
