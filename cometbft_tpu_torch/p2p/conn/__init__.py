"""Connection layer (a part of cometbft_tpu/p2p/conn/): the channel
descriptor only, until the wire is ported."""

from cometbft_tpu_torch.p2p.conn.connection import ChannelDescriptor

__all__ = ["ChannelDescriptor"]
