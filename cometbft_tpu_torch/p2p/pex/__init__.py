"""Peer exchange (PEX): address book + discovery reactor (a copy of
cometbft_tpu/p2p/pex; reference: p2p/pex/addrbook.go,
p2p/pex/pex_reactor.go)."""

from cometbft_tpu_torch.p2p.pex.addrbook import AddrBook, KnownAddress
from cometbft_tpu_torch.p2p.pex.reactor import PEX_CHANNEL, PexReactor

__all__ = ["AddrBook", "KnownAddress", "PexReactor", "PEX_CHANNEL"]
