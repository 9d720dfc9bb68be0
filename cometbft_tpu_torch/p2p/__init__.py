"""p2p plane (a part of cometbft_tpu/p2p/): the reactor base and the
channel descriptor.  ``MConnection``, the secret connection, the switch,
the transport and peers come with the wire."""

from cometbft_tpu_torch.p2p.base_reactor import Envelope, Reactor
from cometbft_tpu_torch.p2p.conn import ChannelDescriptor

__all__ = ["ChannelDescriptor", "Envelope", "Reactor"]
