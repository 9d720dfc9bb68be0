"""In-process p2p helpers (a copy of cometbft_tpu/p2p/test_util.py;
reference: p2p/test_util.go).

Real localhost TCP switches: ``make_switch`` builds a switch listening
on an ephemeral port; ``connect_switches`` dials them together.  The
tests and chip_smoke.py build nodes with these.
"""

from __future__ import annotations

import time

from cometbft_tpu_torch.crypto.ed25519 import gen_priv_key
from cometbft_tpu_torch.p2p.conn.netem import NetemPlan
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.netaddr import NetAddress
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.p2p.transport import MultiplexTransport


def make_switch(
    network: str = "test-net",
    moniker: str = "test",
    reactors: dict | None = None,
    channels: bytes | None = None,
    netem: NetemPlan | None = None,
) -> Switch:
    """Build a started transport + switch bound to 127.0.0.1:0.
    ``netem``: a WAN-emulation plan every connection of the switch
    sends through."""
    node_key = NodeKey(gen_priv_key())
    # channel byte-string advertised in NodeInfo; computed after reactors
    chs = channels
    if chs is None and reactors:
        chs = bytes(
            d.id for r in reactors.values() for d in r.get_channels()
        )
    ni = NodeInfo(
        node_id=node_key.id(),
        listen_addr="tcp://127.0.0.1:0",
        network=network,
        channels=chs or b"",
        moniker=moniker,
    )
    transport = MultiplexTransport(ni, node_key)
    sw = Switch(transport, netem=netem)
    for name, reactor in (reactors or {}).items():
        sw.add_reactor(name, reactor)
    transport.listen(NetAddress(id="", host="127.0.0.1", port=0))
    # listen addr now known; refresh node info so peers learn the real port
    transport.node_info = NodeInfo(
        node_id=ni.node_id,
        listen_addr=f"tcp://127.0.0.1:{transport.listen_addr.port}",
        network=network,
        channels=chs or b"",
        moniker=moniker,
    )
    return sw


def connect_switches(a: Switch, b: Switch, timeout: float = 5.0) -> None:
    """Dial b from a and wait until both peer sets see each other."""
    a.dial_peer_with_address(b.transport.listen_addr)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if a.peers.has(b.node_info().node_id) and b.peers.has(
            a.node_info().node_id
        ):
            return
        time.sleep(0.01)
    raise TimeoutError("switches failed to connect")


__all__ = ["make_switch", "connect_switches"]
