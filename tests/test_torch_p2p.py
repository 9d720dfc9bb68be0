"""The port's wire (cometbft_tpu_torch/p2p and utils/flowrate.py: node
keys and info, addresses, the flow monitor, the handshake primitives,
the native frame AEAD, SecretConnection, MConnection, the transport and
the switch) against the reference's (cometbft_tpu/p2p), which imports no
jax.

The same inputs, made from a seed with numpy, go to both packages.  The
reference runs its handshake and AEAD through `cryptography` (OpenSSL)
where it is installed, so a port/reference pair over a socket is a test
against OpenSSL; the port imports no `cryptography`.  Tolerance: exact
-- wire bytes (addresses, node-key files, NodeInfo, packets, X25519,
HKDF, sealed frames), refusals (exception class and message), the flow
monitor's sleeps under one scripted clock, the channel picked at every
send step, and the P2P metrics' exposition after one scripted peer
life.  Connections run over real sockets on 127.0.0.1; every wait is
bounded."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from cometbft_tpu import metrics as rmetrics
from cometbft_tpu.crypto import ed25519 as red
from cometbft_tpu.p2p import base_reactor as rbase
from cometbft_tpu.p2p import key as rkey
from cometbft_tpu.p2p import netaddr as rnetaddr
from cometbft_tpu.p2p import node_info as rnode_info
from cometbft_tpu.p2p import switch as rswitch
from cometbft_tpu.p2p import test_util as rtest_util
from cometbft_tpu.p2p import transport as rtransport
from cometbft_tpu.p2p.conn import connection as rconn
from cometbft_tpu.p2p.conn import crypto_fallback as rfallback
from cometbft_tpu.p2p.conn import frame_native as rframe
from cometbft_tpu.p2p.conn import secret_connection as rsc
from cometbft_tpu.utils import flowrate as rflow
from cometbft_tpu.utils import metrics as rumetrics
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.p2p import base_reactor as pbase
from cometbft_tpu_torch.p2p import key as pkey
from cometbft_tpu_torch.p2p import netaddr as pnetaddr
from cometbft_tpu_torch.p2p import node_info as pnode_info
from cometbft_tpu_torch.p2p import switch as pswitch
from cometbft_tpu_torch.p2p import test_util as ptest_util
from cometbft_tpu_torch.p2p import transport as ptransport
from cometbft_tpu_torch.p2p.conn import connection as pconn
from cometbft_tpu_torch.p2p.conn import frame_native as pframe
from cometbft_tpu_torch.p2p.conn import handshake_crypto as phc
from cometbft_tpu_torch.p2p.conn import secret_connection as psc
from cometbft_tpu_torch.utils import flowrate as pflow
from cometbft_tpu_torch.utils import metrics as pumetrics
from tests.test_torch_types import outcome

SEED = 0x9214
WAIT = 10.0
CH = 0x77

REF = dict(key=rkey, netaddr=rnetaddr, node_info=rnode_info, conn=rconn, sc=rsc,
           transport=rtransport, switch=rswitch, util=rtest_util, base=rbase, ed=red,
           flow=rflow, metrics=rmetrics, registry=rumetrics.Registry)
PORT = dict(key=pkey, netaddr=pnetaddr, node_info=pnode_info, conn=pconn, sc=psc,
            transport=ptransport, switch=pswitch, util=ptest_util, base=pbase, ed=ped,
            flow=pflow, metrics=pmetrics, registry=pumetrics.Registry)


def rng(tag: int) -> np.random.Generator:
    return np.random.default_rng(SEED + tag)


def wait_for(cond, timeout: float = WAIT) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# -- addresses -----------------------------------------------------------------

ID = "ab" * 20
ADDRS = [f"tcp://{ID}@10.0.0.1:26656", f"{ID}@h1:1", "127.0.0.1:0", "[::1]:26656",
         f"unix://{ID}@sock:9", f"{ID}@:7", " 1.2.3.4:65535 ", "zz@1.2.3.4:26656",
         f"{ID[:-2]}@1.2.3.4:1", "1.2.3.4:99999", "1.2.3.4", "1.2.3.4:x", "1.2.3.4:-1",
         f"{ID.upper()}@x:2"]


def _addr(side, s):
    a = side["netaddr"].NetAddress.parse(s)
    return (a.id, a.host, a.port, str(a), a.dial_string(), a.routable(), a.local())


@pytest.mark.parametrize("s", ADDRS)
def test_netaddress_parse_equals_the_reference(s):
    got = outcome(lambda: _addr(PORT, s))
    assert got == outcome(lambda: _addr(REF, s))
    if got == ("ok",):
        assert _addr(PORT, s) == _addr(REF, s)
        addr = pnetaddr.NetAddress.parse(s)
        assert pnetaddr.NetAddress.parse(str(addr)) == addr


@pytest.mark.parametrize("spec", ["", f" {ID}@h1:1, {ID}@h2:2 ,", "a:1,b:2,,c:3",
                                  "a:1,bad", f"{ID}@h:1,zz@h:2"])
def test_parse_peer_list_equals_the_reference(spec):
    def run(side):
        return [str(a) for a in side["netaddr"].parse_peer_list(spec)]

    assert outcome(lambda: run(PORT)) == outcome(lambda: run(REF))
    if outcome(lambda: run(REF)) == ("ok",):
        assert run(PORT) == run(REF)


# -- node keys -----------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_node_key_file_loads_in_the_other_package(writer, tmp_path):
    """One secret's key file, written by either package, is byte for
    byte the other's and loads there with the same ID."""
    secret = rng(1).bytes(32)
    pk = pkey.NodeKey(ped.priv_key_from_secret(secret))
    rk = rkey.NodeKey(red.priv_key_from_secret(secret))
    ppath, rpath = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    pk.save_as(ppath)
    rk.save_as(rpath)
    assert open(ppath, "rb").read() == open(rpath, "rb").read()
    src = ppath if writer == "port" else rpath
    loaded_p, loaded_r = pkey.NodeKey.load(src), rkey.NodeKey.load(src)
    assert loaded_p.id() == loaded_r.id() == rk.id() == pk.id()
    assert loaded_p.priv_key.bytes() == loaded_r.priv_key.bytes()
    assert json.load(open(src))["priv_key"]["type"] == "tendermint/PrivKeyEd25519"
    assert pkey.pub_key_to_id(loaded_p.pub_key) == rkey.pub_key_to_id(loaded_r.pub_key)
    msg = rng(2).bytes(77)
    assert loaded_p.sign(msg) == loaded_r.sign(msg)
    fresh = str(tmp_path / "sub" / "fresh.json")
    made = (pkey if writer == "port" else rkey).NodeKey.load_or_generate(fresh)
    other = (rkey if writer == "port" else pkey).NodeKey.load_or_generate(fresh)
    assert made.id() == other.id()


@pytest.mark.parametrize("node_id", [ID, ID[:-1], ID + "00", "g" * 40, ""])
def test_validate_id_equals_the_reference(node_id):
    assert outcome(lambda: pkey.validate_id(node_id)) == \
        outcome(lambda: rkey.validate_id(node_id))


# -- node info -----------------------------------------------------------------

def _infos(side, tag: int) -> list:
    g = rng(tag)
    NI, PV = side["node_info"].NodeInfo, side["node_info"].ProtocolVersion
    out = []
    for i in range(4):
        out.append(NI(node_id=g.bytes(20).hex(), listen_addr=f"tcp://10.0.0.{i}:{26656 + i}",
                      network=f"chain-{int(g.integers(1000))}", version=f"0.{i}.1",
                      channels=bytes(sorted(set(int(c) for c in g.integers(0, 128, 3 + i)))),
                      moniker=f"node-{g.bytes(3).hex()}",
                      protocol_version=PV(p2p=9, block=11 + (i == 3), app=int(g.integers(9))),
                      tx_index=("on", "off")[i % 2], rpc_address=f"tcp://0.0.0.0:{26657 + i}"))
    out.append(NI(node_id=ID, listen_addr="", network="n"))
    return out


def _info_tuple(ni) -> tuple:
    pv = ni.protocol_version
    return (ni.node_id, ni.listen_addr, ni.network, ni.version, ni.channels, ni.moniker,
            (pv.p2p, pv.block, pv.app), ni.tx_index, ni.rpc_address)


def test_node_info_bytes_equal_the_reference_both_ways():
    for p, r in zip(_infos(PORT, 3), _infos(REF, 3)):
        assert p.encode() == r.encode()
        assert _info_tuple(pnode_info.NodeInfo.decode(r.encode())) == _info_tuple(r)
        assert _info_tuple(rnode_info.NodeInfo.decode(p.encode())) == _info_tuple(p)
    huge = b"\x12" + b"\xff\x4f" + b"a" * 10300
    assert outcome(lambda: pnode_info.NodeInfo.decode(huge)) == \
        outcome(lambda: rnode_info.NodeInfo.decode(huge))


COMPAT = ["same", "block", "network", "channels", "one_empty", "p2p_and_app"]


def _compat_case(side, case: str):
    NI, PV = side["node_info"].NodeInfo, side["node_info"].ProtocolVersion
    ours = NI(node_id=ID, listen_addr="", network="net", channels=b"\x20\x40")
    theirs = {"same": dict(), "block": dict(protocol_version=PV(block=12)),
              "network": dict(network="other"), "channels": dict(channels=b"\x30"),
              "one_empty": dict(channels=b""),
              "p2p_and_app": dict(protocol_version=PV(p2p=8, app=5))}[case]
    base = dict(node_id="cd" * 20, listen_addr="", network="net", channels=b"\x40")
    base.update(theirs)
    return lambda: ours.compatible_with(NI(**base))


@pytest.mark.parametrize("case", COMPAT)
def test_compatibility_refusals_equal_the_reference(case):
    assert outcome(_compat_case(PORT, case)) == outcome(_compat_case(REF, case))


VALIDATE = ["ok", "bad_id", "many_channels", "duplicate", "empty_moniker", "long_moniker"]


@pytest.mark.parametrize("case", VALIDATE)
def test_node_info_validation_equals_the_reference(case):
    def run(side):
        kw = dict(node_id=ID, listen_addr="", network="n", channels=b"\x01\x02")
        kw.update({"ok": {}, "bad_id": dict(node_id="xy"),
                   "many_channels": dict(channels=bytes(range(17))),
                   "duplicate": dict(channels=b"\x01\x01"), "empty_moniker": dict(moniker=""),
                   "long_moniker": dict(moniker="m" * 257)}[case])
        return lambda: side["node_info"].NodeInfo(**kw).validate()

    assert outcome(run(PORT)) == outcome(run(REF))


# -- packets -------------------------------------------------------------------

def _packets(side) -> list:
    C = side["conn"]
    g = rng(4)
    out = [C.encode_packet_ping(), C.encode_packet_pong(), C.encode_packet_pong(1.5e9 + 0.25),
           C.encode_packet_pong(0.0)]
    for ch, eof, n in ((0x40, True, 0), (0x40, False, 1024), (0x20, True, 17), (0xFF, True, 1)):
        out.append(C.encode_packet_msg(ch, eof, g.bytes(n)))
    return out


BAD_PACKETS = [b"", b"\x08\x01", b"\x1a\x02\x08", b"\x12\x03\x08\xff\xff", b"\x12\x02\x12\x00",
               b"\x1a\x04\x08\x40\x10\x01", b"\x22\x00"]


def test_packets_equal_the_reference_both_ways():
    port, ref = _packets(PORT), _packets(REF)
    assert port == ref
    for raw in ref + BAD_PACKETS:
        assert outcome(lambda: pconn.decode_packet(raw)) == \
            outcome(lambda: rconn.decode_packet(raw))
        if outcome(lambda: rconn.decode_packet(raw)) == ("ok",):
            assert pconn.decode_packet(raw) == rconn.decode_packet(raw)
    assert pconn.decode_packet(port[1]) == ("pong", None)
    assert pconn.decode_packet(port[2]) == ("pong", int((1.5e9 + 0.25) * 1e9))


# -- the flow monitor ----------------------------------------------------------

class Clock:
    """monotonic() and sleep() of one scripted clock; sleeps recorded."""

    def __init__(self) -> None:
        self.t = 500.0
        self.sleeps: list = []

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.sleeps.append(round(s, 9))
        self.t += s


def _flow_script(side, monkeypatch) -> tuple:
    clock = Clock()
    monkeypatch.setattr(side["flow"], "time", clock)
    mon = side["flow"].Monitor()
    got = [mon.update(10_000), mon.limit(10_000, 100_000), mon.limit(250_000, 100_000),
           mon.limit(0, 5), mon.limit(7, 0)]
    clock.t += 0.35
    got.append(mon.update(3000))
    clock.t += 5.0
    got.append(mon.status())
    mon.done()
    got.append(mon.limit(10**9, 10))
    return got, clock.sleeps, clock.t


def test_flow_monitor_limits_as_the_reference(monkeypatch):
    """Under one scripted clock both monitors sleep the same steps (at
    most 0.1 s each), permit the same bytes and report the same rates."""
    got = _flow_script(PORT, monkeypatch)
    assert got == _flow_script(REF, monkeypatch)
    sleeps = got[1]
    assert sleeps and max(sleeps) <= 0.1 and sum(sleeps) >= 1.4


def test_flow_monitor_limit_blocks_in_real_time():
    mon = pflow.Monitor()
    mon.update(10_000)
    t0 = time.monotonic()
    assert mon.limit(150_000, 100_000) == 150_000
    assert 0.4 <= time.monotonic() - t0 < 5.0


# -- X25519, HKDF and the AEAD -------------------------------------------------

# RFC 7748 section 6.1
ALICE = ("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
         "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
BOB = ("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
       "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
SHARED = "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"


def test_x25519_rfc7748_vectors():
    a = phc.X25519PrivateKey(bytes.fromhex(ALICE[0]))
    b = phc.X25519PrivateKey(bytes.fromhex(BOB[0]))
    assert a.public_key().public_bytes_raw().hex() == ALICE[1]
    assert b.public_key().public_bytes_raw().hex() == BOB[1]
    assert a.exchange(phc.X25519PublicKey.from_public_bytes(bytes.fromhex(BOB[1]))).hex() \
        == SHARED
    assert b.exchange(phc.X25519PublicKey.from_public_bytes(bytes.fromhex(ALICE[1]))).hex() \
        == SHARED
    # section 5.2: one iteration of the scalar-multiplication loop
    k = bytes.fromhex("0900000000000000000000000000000000000000000000000000000000000000")
    assert phc.X25519PrivateKey(k).exchange(phc.X25519PublicKey(k)).hex() == \
        "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"


def test_x25519_equals_the_reference():
    """The port's ladder against the reference's X25519 (OpenSSL through
    `cryptography` where installed) and its own pure-Python copy, on
    seeded keys and peer points (the top bit of a u-coordinate set)."""
    g = rng(5)
    ref_x = rsc.X25519PrivateKey
    for _ in range(6):
        seed, peer = g.bytes(32), bytearray(g.bytes(32))
        peer[31] |= 0x80
        mine = phc.X25519PrivateKey(seed)
        theirs = ref_x.from_private_bytes(seed) if hasattr(ref_x, "from_private_bytes") \
            else ref_x(seed)
        assert mine.public_key().public_bytes_raw() == \
            theirs.public_key().public_bytes_raw() == \
            rfallback.X25519PrivateKey(seed).public_key().public_bytes_raw()
        want = rfallback.X25519PrivateKey(seed).exchange(rfallback.X25519PublicKey(bytes(peer)))
        assert mine.exchange(phc.X25519PublicKey(bytes(peer))) == want
        other = phc.X25519PrivateKey(g.bytes(32)).public_key().public_bytes_raw()
        assert mine.exchange(phc.X25519PublicKey(other)) == \
            theirs.exchange(rsc.X25519PublicKey.from_public_bytes(other))


@pytest.mark.parametrize("length", [32, 64, 96, 100])
def test_hkdf_equals_the_reference(length):
    g = rng(6 + length)
    for _ in range(3):
        secret, info = g.bytes(32), g.bytes(int(g.integers(0, 80)))
        assert phc.hkdf_sha256(secret, info, length) == rsc._hkdf(secret, info, length)
        assert psc._hkdf(secret, info, length) == rsc._hkdf(secret, info, length)


RFC8439_KEY = bytes(range(0x80, 0xA0))
RFC8439_NONCE = bytes.fromhex("070000004041424344454647")
RFC8439_AAD = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
RFC8439_PT = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one "
              b"tip for the future, sunscreen would be it.")
RFC8439_CT = ("d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca9"
              "671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee3"
              "28091b58fab324e4fad675945585808b4831d7bc3ff4def08e4b7a9de576d26586cec64b6116",
              "1ae10b594f09e26a7e902ecbd0600691")


def test_aead_rfc8439_vector():
    aead = phc.ChaCha20Poly1305(RFC8439_KEY)
    sealed = aead.encrypt(RFC8439_NONCE, RFC8439_PT, RFC8439_AAD)
    assert len(sealed) == len(RFC8439_PT) + 16
    assert sealed[:-16].hex() == RFC8439_CT[0] and sealed[-16:].hex() == RFC8439_CT[1]
    assert aead.decrypt(RFC8439_NONCE, sealed, RFC8439_AAD) == RFC8439_PT
    bad = bytearray(sealed)
    bad[3] ^= 1
    with pytest.raises(phc.InvalidTag):
        aead.decrypt(RFC8439_NONCE, bytes(bad), RFC8439_AAD)
    with pytest.raises(phc.InvalidTag):
        aead.decrypt(RFC8439_NONCE, sealed, RFC8439_AAD + b"!")


def test_aead_equals_openssl():
    """The native AEAD and `cryptography`'s ChaCha20Poly1305 give the
    same bytes for the same key, nonce and AAD, and open each other's."""
    aead_mod = pytest.importorskip("cryptography.hazmat.primitives.ciphers.aead")
    g = rng(7)
    for n in (0, 1, 63, 64, 65, 1028, 5000):
        key, nonce = g.bytes(32), g.bytes(12)
        aad, pt = g.bytes(int(g.integers(0, 40))), g.bytes(n)
        ossl = aead_mod.ChaCha20Poly1305(key)
        mine = phc.ChaCha20Poly1305(key)
        assert mine.encrypt(nonce, pt, aad) == ossl.encrypt(nonce, pt, aad)
        assert mine.decrypt(nonce, ossl.encrypt(nonce, pt, aad), aad) == pt
        assert mine.encrypt(nonce, pt, None) == ossl.encrypt(nonce, pt, None)


def test_frames_equal_the_reference_pump():
    """Sealed frame bursts byte for byte the reference pump's, opened
    alike, a bad frame named alike (the valid prefix delivered)."""
    plib, rlib = pframe.load(), rframe.load()
    if rlib is None:
        pytest.skip("the reference's frame pump did not build")
    g = rng(8)
    key = g.bytes(32)
    for nonce0, size in ((0, 0), (1, 1), (2, 1023), (5, 1024), (9, 1025), (11, 4096),
                         (1 << 40, 3333)):
        data = g.bytes(size)
        sealed = bytes(pframe.seal_frames(plib, key, nonce0, data))
        assert sealed == bytes(rframe.seal_frames(rlib, key, nonce0, data))
        assert pframe.open_frames(plib, key, nonce0, sealed) == data
        bad = bytearray(sealed)
        bad[len(sealed) - 1044 + 7] ^= 1
        assert pframe.open_frames_partial(plib, key, nonce0, bytes(bad)) == \
            rframe.open_frames_partial(rlib, key, nonce0, bytes(bad))
    assert outcome(lambda: pframe.open_frames(plib, key, 3, b"x" * 1043)) == \
        outcome(lambda: rframe.open_frames(rlib, key, 3, b"x" * 1043))


def test_portable_backend_equals_the_evp_one():
    """The frame library's portable RFC 8439 code (forced in a fresh
    process) seals what its EVP backend seals, and passes the RFC 8439
    vector; the backend is chosen once per process."""
    lib = pframe.load()
    key, data = bytes(range(32)), bytes(range(256)) * 9
    code = (
        "import ctypes, sys\n"
        "from cometbft_tpu_torch.p2p.conn import frame_native as F, handshake_crypto as H\n"
        "lib = F.load()\n"
        "assert lib.cmt_frame_backend() == 0\n"
        f"key, nonce, aad, pt = {RFC8439_KEY!r}, {RFC8439_NONCE!r}, {RFC8439_AAD!r}, "
        f"{RFC8439_PT!r}\n"
        f"assert H.ChaCha20Poly1305(key).encrypt(nonce, pt, aad).hex() == "
        f"{RFC8439_CT[0] + RFC8439_CT[1]!r}\n"
        "sys.stdout.buffer.write(bytes(F.seal_frames(lib, bytes(range(32)), 3, "
        "bytes(range(256)) * 9)))\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CMT_TPU_FRAME_SCALAR="1", PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo, capture_output=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    assert out.stdout == bytes(pframe.seal_frames(lib, key, 3, data))


# -- SecretConnection across packages -----------------------------------------

def _tcp_pair():
    """(dialled-from socket, accepted socket) over 127.0.0.1."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    dialer = socket.create_connection(srv.getsockname(), timeout=WAIT)
    accepted, _ = srv.accept()
    srv.close()
    dialer.settimeout(WAIT)
    accepted.settimeout(WAIT)
    return dialer, accepted


def _secret_pair(dialer_side, acceptor_side, tag: int):
    """Handshake a SecretConnection of ``dialer_side`` on the dialling
    socket with one of ``acceptor_side`` on the accepted one -> (dialler's,
    acceptor's, their keys)."""
    g = rng(tag)
    ka = dialer_side["ed"].priv_key_from_secret(g.bytes(32))
    kb = acceptor_side["ed"].priv_key_from_secret(g.bytes(32))
    s1, s2 = _tcp_pair()
    out = {}

    def accept():
        try:
            out["conn"] = acceptor_side["sc"].SecretConnection(s2, kb)
        except Exception as exc:  # noqa: BLE001 -- raised below
            out["err"] = exc

    t = threading.Thread(target=accept)
    t.start()
    c1 = dialer_side["sc"].SecretConnection(s1, ka)
    t.join(WAIT)
    assert not t.is_alive() and "err" not in out, out
    return c1, out["conn"], ka, kb


SIZES = [0, 1, 1023, 1024, 1025, 300 * 1024]


def _exchange(a, b, g) -> None:
    """Each size written by ``a`` reads back equal at ``b`` and back."""
    for n in SIZES:
        data = g.bytes(n)
        for w, r in ((a, b), (b, a)):
            w.write(data)
            if n == 0:
                assert r.read() == b""
            elif n > 64 * 1024:
                got = {}
                t = threading.Thread(target=lambda: got.update(v=r.read_exact(n)))
                t.start()
                t.join(WAIT)
                assert got.get("v") == data
            else:
                assert r.read_exact(n) == data


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_secret_connection_interoperates(dialer):
    """A port and a reference SecretConnection complete the handshake
    with either side dialling, authenticate each other's node key and
    carry writes of 0, 1, 1023, 1024, 1025 and 300 KB both ways."""
    d, a = (PORT, REF) if dialer == "port" else (REF, PORT)
    c1, c2, k1, k2 = _secret_pair(d, a, 10)
    try:
        assert c1.remote_pubkey.bytes() == k2.pub_key().bytes()
        assert c2.remote_pubkey.bytes() == k1.pub_key().bytes()
        _exchange(c1, c2, rng(11))
    finally:
        c1.close()
        c2.close()


class Tamper:
    """A socket whose sent bytes have one byte flipped at ``at``."""

    def __init__(self, sock, at: int) -> None:
        self.sock, self.at = sock, at

    def sendall(self, b) -> None:
        b = bytearray(b)
        b[self.at] ^= 0x01
        self.sock.sendall(bytes(b))

    def recv(self, n):
        return self.sock.recv(n)

    def fileno(self):
        return self.sock.fileno()

    def close(self) -> None:
        self.sock.close()


@pytest.mark.parametrize("frames", [1, 3])
def test_flipped_ciphertext_raises_the_ports_typed_error(frames):
    """A byte flipped in the reference's sealed frame (in the second of
    three frames for a batched open) raises psc.SecretConnectionError at
    the port: the valid frames before it are delivered first."""
    c_ref, c_port, _, _ = _secret_pair(REF, PORT, 12)
    try:
        c_ref._sock = Tamper(c_ref._sock, 10 if frames == 1 else 1044 + 10)
        data = rng(13).bytes(100 if frames == 1 else 3000)
        c_ref.write(data)
        if frames == 1:
            with pytest.raises(psc.SecretConnectionError):
                c_port.read()
        else:
            assert wait_for(lambda: len(_peek(c_port._sock)) >= 3 * 1044)
            assert c_port.read() == data[:1024]
            with pytest.raises(psc.SecretConnectionError, match="frame auth failed"):
                c_port.read()
    finally:
        c_ref.close()
        c_port.close()


def _peek(sock) -> bytes:
    try:
        return sock.recv(1 << 16, socket.MSG_PEEK | socket.MSG_DONTWAIT)
    except BlockingIOError:
        return b""


def test_handshake_is_observed_and_refuses_a_low_order_point():
    reg = pumetrics.Registry()
    pmetrics.install_p2p_metrics(pmetrics.P2PMetrics(reg))
    try:
        c1, c2, _, _ = _secret_pair(PORT, PORT, 14)
        c1.close()
        c2.close()
        text = reg.expose()
        assert "cometbft_p2p_handshake_duration_seconds_count 2" in text
        assert 'cometbft_p2p_secret_frames_total{direction="seal"} 2' in text
    finally:
        pmetrics.install_p2p_metrics(None)
    s1, s2 = _tcp_pair()
    s2.sendall(bytes(32))     # the zero point: a low-order ephemeral key
    with pytest.raises(psc.SecretConnectionError, match="low-order"):
        psc.SecretConnection(s1, ped.priv_key_from_secret(b"x"))
    s1.close()
    s2.close()


# -- MConnection ---------------------------------------------------------------

class Plain:
    """A plaintext stream (write/read_exact/close) over a socket; keeps
    what it wrote."""

    def __init__(self, sock) -> None:
        self.sock, self.wrote = sock, []

    def write(self, b) -> int:
        self.wrote.append(bytes(b))
        self.sock.sendall(b)
        return len(b)

    def read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def _mconn(side, sock, chs, got, cfg=None):
    C = side["conn"]
    descs = [C.ChannelDescriptor(id=i, priority=p) for i, p in chs]
    return C.MConnection(Plain(sock), descs, lambda ch, m: got.append((ch, m)),
                         config=cfg or C.MConnConfig(ping_interval=3600))


@pytest.mark.parametrize("port_side", ["first", "second"])
def test_mconnection_interoperates_and_chunks_like_the_reference(port_side):
    """A port MConnection and a reference one over a socket pair carry
    messages both ways on two channels; a 5000-byte message leaves as
    the reference's five 1024-byte-payload packets, byte for byte."""
    s1, s2 = socket.socketpair()
    got1, got2 = [], []
    sides = (PORT, REF) if port_side == "first" else (REF, PORT)
    chs = [(0x01, 5), (0x02, 1)]
    m1, m2 = _mconn(sides[0], s1, chs, got1), _mconn(sides[1], s2, chs, got2)
    m1.start()
    m2.start()
    g = rng(15)
    big, small = g.bytes(5000), g.bytes(10)
    try:
        assert m1.send(0x01, big)
        assert wait_for(lambda: len(got2) == 1)
        assert m1.send(0x02, small) and m2.send(0x01, small) and m2.try_send(0x02, big)
        assert wait_for(lambda: len(got2) == 2 and len(got1) == 2)
        assert got2 == [(0x01, big), (0x02, small)]
        assert sorted(got1) == [(0x01, small), (0x02, big)]
        wire = b"".join(m1.conn.wrote)
        want = b""
        for i in range(0, 5000, 1024):
            pkt = rconn.encode_packet_msg(0x01, i + 1024 >= 5000, big[i:i + 1024])
            want += rconn.encode_uvarint(len(pkt)) + pkt
        assert wire.startswith(want)
        status = m1.status()
        assert status["send"]["bytes"] == len(wire) and status["pending_send_bytes"] == 0
        assert [c["id"] for c in status["channels"]] == [0x01, 0x02]
    finally:
        m1.stop()
        m2.stop()


def _pick_order(side) -> list:
    """The channel the send routine picks at each step, two channels of
    priorities 5 and 1 with queued messages, decaying as it does."""
    C = side["conn"]
    descs = [C.ChannelDescriptor(id=0x01, priority=5), C.ChannelDescriptor(id=0x02, priority=1),
             C.ChannelDescriptor(id=0x03, priority=2)]
    m = C.MConnection(Plain(socket.socketpair()[0]), descs, lambda ch, msg: None)
    g = rng(16)
    for i in range(6):
        for ch in (0x01, 0x02, 0x03):
            n = int(g.integers(1, 3000))
            m.channels[ch].note_enqueued(n)
            m.channels[ch].send_queue.put_nowait(g.bytes(n))
    order = []
    step = 0
    while True:
        ch = m._select_channel()
        if ch is None:
            break
        eof, chunk = ch.next_packet(m.config.max_packet_msg_payload_size)
        pkt = C.encode_packet_msg(ch.desc.id, eof, chunk)
        ch.recently_sent += len(pkt) + 2
        order.append((ch.desc.id, eof, len(chunk)))
        step += 1
        if step % 7 == 0:
            m._decay_recently_sent()
    m.conn.close()
    return order


def test_mconnection_priorities_equal_the_reference():
    order = _pick_order(PORT)
    assert order == _pick_order(REF)
    first = [ch for ch, _, _ in order[:12]]
    assert first.count(0x01) > first.count(0x02)


def test_mconnection_refuses_an_unknown_channel_and_dies_on_eof():
    s1, s2 = socket.socketpair()
    errs, got = [], []
    m = pconn.MConnection(Plain(s1), [pconn.ChannelDescriptor(id=1)], lambda c, b: got.append(b),
                          on_error=errs.append, config=pconn.MConnConfig(ping_interval=3600))
    with pytest.raises(pconn.MConnError, match="unknown channel 0x9"):
        m.send(9, b"x")
    assert not m.send(1, b"x")     # not running
    m.start()
    pkt = pconn.encode_packet_msg(5, True, b"hi")
    s2.sendall(pconn.encode_uvarint(len(pkt)) + pkt)
    assert wait_for(lambda: errs)
    assert "unknown channel 0x5" in m.last_error and not m.is_running()
    s2.close()


@pytest.mark.parametrize("n", [1, 40])
def test_flush_then_stop_delivers_every_byte(n):
    """A port MConnection's channel holds ``n`` queued messages; after
    flush() returns True the connection is stopped at once, and the
    reference peer has still received every byte."""
    s1, s2 = socket.socketpair()
    got = []
    m1, m2 = _mconn(PORT, s1, [(0x01, 1)], []), _mconn(REF, s2, [(0x01, 1)], got)
    g = rng(17)
    msgs = [g.bytes(3000) for _ in range(n)]
    m2.start()
    m1.start()
    try:
        for msg in msgs:
            assert m1.send(0x01, msg)
        assert m1.flush(WAIT)
        m1.stop()
        assert wait_for(lambda: len(got) == n)
        assert got == [(0x01, msg) for msg in msgs]
    finally:
        if m1.is_running():
            m1.stop()
        m2.stop()


def test_flush_sees_a_packet_taken_between_its_reads():
    """The send routine takes the last packet while flush() looks at the
    channels, and its write is held: flush() must not report the bytes
    written while they sit in the routine's buffer.  The connection is
    stopped as soon as flush() returns, and the peer must hold the
    message."""
    s1, s2 = socket.socketpair()
    got = []
    m1, m2 = _mconn(PORT, s1, [(0x01, 1)], []), _mconn(REF, s2, [(0x01, 1)], got)
    ch = m1.channels[0x01]
    release, taken, write_ok = threading.Event(), threading.Event(), threading.Event()
    select, take, write, real_pending = (m1._select_channel, ch.next_packet, m1.conn.write,
                                         ch.is_send_pending)
    flusher = threading.current_thread()
    looks = []

    def gated_select():
        release.wait(WAIT)
        return select()

    def took(max_payload):
        out = take(max_payload)
        taken.set()
        return out

    def held_write(b):
        write_ok.wait(WAIT)
        return write(b)

    def pending():
        if threading.current_thread() is flusher:
            looks.append(1)
            if len(looks) == 1:
                release.set()       # the routine takes the packet now
                assert taken.wait(WAIT)
            else:
                write_ok.set()      # flush() looked again: let the bytes out
        return real_pending()

    m1._select_channel, ch.next_packet, m1.conn.write = gated_select, took, held_write
    ch.is_send_pending = pending
    msg = rng(18).bytes(100)
    m2.start()
    m1.start()
    try:
        assert m1.send(0x01, msg)
        assert m1.flush(WAIT)
        m1.stop()
        write_ok.set()
        assert wait_for(lambda: got, timeout=2.0)
        assert got == [(0x01, msg)] and len(looks) >= 2
    finally:
        write_ok.set()
        if m1.is_running():
            m1.stop()
        m2.stop()


# -- switches over TCP ---------------------------------------------------------

def _echo_reactor(side):
    base = side["base"]

    class Echo(base.Reactor):
        """Echoes every message not starting with b"echo:" back."""

        def __init__(self) -> None:
            super().__init__(name="echo")
            self.received: list = []
            self.removed: list = []

        def get_channels(self):
            return [side["conn"].ChannelDescriptor(id=CH, priority=1)]

        def receive(self, env) -> None:
            self.received.append(env.message)
            if not env.message.startswith(b"echo:"):
                env.src.send(CH, b"echo:" + env.message)

        def remove_peer(self, peer, reason=None) -> None:
            self.removed.append(peer.id)

    return Echo()


def _switch(side, network: str = "test-net", moniker: str = "n"):
    r = _echo_reactor(side)
    sw = side["util"].make_switch(network=network, moniker=moniker, reactors={"echo": r})
    sw.start()
    return sw, r


def _stop(*switches) -> None:
    for sw in switches:
        if sw.is_running():
            sw.stop()


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_switches_echo_across_packages(dialer):
    (sa, ra), (sb, rb) = _switch(PORT), _switch(REF)
    try:
        if dialer == "port":
            ptest_util.connect_switches(sa, sb)
        else:
            rtest_util.connect_switches(sb, sa)
        g = rng(17)
        m1, m2 = g.bytes(300), g.bytes(20000)
        assert sa.peers.copy()[0].send(CH, m1)
        assert sb.peers.copy()[0].send(CH, m2)
        assert wait_for(lambda: b"echo:" + m1 in ra.received and b"echo:" + m2 in rb.received)
        assert m1 in rb.received and m2 in ra.received
        pa, pb = sa.peers.copy()[0], sb.peers.copy()[0]
        assert pa.id == sb.node_info().node_id and pb.id == sa.node_info().node_id
        assert pa.is_outbound() == (dialer == "port")
        assert sa.num_peers() == {"outbound": int(dialer == "port"),
                                  "inbound": int(dialer != "port"), "dialing": 0}
    finally:
        _stop(sa, sb)


@pytest.mark.parametrize("dialer", ["port", "reference"])
def test_wrong_network_is_refused_across_packages(dialer):
    (sa, _), (sb, _) = _switch(PORT, "net-A"), _switch(REF, "net-B")
    try:
        d, other = (sa, sb) if dialer == "port" else (sb, sa)
        assert d.dial_peer_with_address(other.transport.listen_addr) is False
        time.sleep(0.2)
        assert sa.peers.size() == 0 and sb.peers.size() == 0
        raw = socket.create_connection(("127.0.0.1", sb.transport.listen_addr.port), WAIT)
        k = pkey.NodeKey(ped.priv_key_from_secret(b"wrong-net"))
        ni = pnode_info.NodeInfo(node_id=k.id(), listen_addr="", network="net-A",
                                 channels=bytes([CH]))
        tr = ptransport.MultiplexTransport(ni, k)
        with pytest.raises(ptransport.RejectedError, match="peer network") as err:
            tr._upgrade(raw, None)
        assert err.value.is_incompatible
        raw.close()
    finally:
        _stop(sa, sb)


@pytest.mark.parametrize("stopped", ["port", "reference"])
def test_disconnect_is_seen_on_both_sides(stopped):
    (sa, ra), (sb, rb) = _switch(PORT), _switch(REF)
    try:
        ptest_util.connect_switches(sa, sb)
        # running, and past the add->start window: a service reads as
        # running before its on_start has started the connection's
        # threads, and the reference's stop() raises in that window (its
        # switch.py:353-355; test_stop_with_a_peer_between_add_and_start)
        assert wait_for(lambda: all(
            p.is_running() and p.mconn._recv_thread is not None
            and p.mconn._recv_thread.ident is not None
            for p in sa.peers.copy() + sb.peers.copy()))
        gone, stays, r_stays = (sa, sb, rb) if stopped == "port" else (sb, sa, ra)
        gone_id = gone.node_info().node_id
        gone.stop()
        assert wait_for(lambda: stays.peers.size() == 0)
        assert r_stays.removed == [gone_id]
    finally:
        _stop(sa, sb)


def test_stop_peer_for_error_records_and_closes():
    from cometbft_tpu_torch.utils.flight import FLIGHT

    (sa, ra), (sb, rb) = _switch(PORT), _switch(PORT)
    try:
        ptest_util.connect_switches(sa, sb)
        assert wait_for(lambda: all(p.is_running() for p in sa.peers.copy() + sb.peers.copy()))
        peer = sa.peers.copy()[0]
        FLIGHT.clear()
        sa.stop_peer_for_error(peer, "sent invalid block")
        sa.stop_peer_for_error(peer, "again")          # already gone: no second record
        assert [e["reason"] for e in FLIGHT.events() if e["kind"] == "peer_error"][:1] == \
            ["sent invalid block"]
        assert not peer.is_running() and ra.removed == [peer.id]
        assert wait_for(lambda: sb.peers.size() == 0)
        assert wait_for(lambda: not peer.mconn._recv_thread.is_alive())
    finally:
        _stop(sa, sb)


def test_a_handshake_that_ends_after_the_stop_starts_no_peer():
    """A dial whose handshake ends as the switch stops: the switch refuses
    the connection and starts no peer, whose connection's threads nobody
    would stop (the port's switch; the reference's starts it)."""
    (sa, _), (sb, _) = _switch(PORT), _switch(PORT)
    try:
        conn, ni = sa.transport.dial(sb.transport.listen_addr)
        # the acceptor's peer started first: its threads are not the dialler's
        assert wait_for(lambda: sb.peers.size() == 1 and all(
            p.is_running() and p.mconn._ping_thread is not None     # started last
            and p.mconn._ping_thread.ident is not None for p in sb.peers.copy()))
        mconn_threads = lambda: {t.ident for t in threading.enumerate()  # noqa: E731
                                 if t.name.startswith("mconn")}
        before = mconn_threads()
        sa.stop()
        assert sa._add_peer_conn(conn, ni, sb.transport.listen_addr, outbound=True) is False
        assert sa.peers.size() == 0 and mconn_threads() <= before
        assert wait_for(lambda: sb.peers.size() == 0)
    finally:
        _stop(sa, sb)


def test_broadcast_reaches_every_peer():
    hub, hub_r = _switch(PORT, moniker="hub")
    spokes = [_switch(s, moniker=f"s{i}") for i, s in enumerate((REF, PORT, REF))]
    try:
        for sw, _ in spokes:
            ptest_util.connect_switches(hub, sw)
        hub.broadcast(CH, b"echo:all")      # prefixed: no echo back
        assert wait_for(lambda: all(b"echo:all" in r.received for _, r in spokes))
        assert hub_r.received == []
    finally:
        _stop(hub, *(sw for sw, _ in spokes))


# -- P2PMetrics ----------------------------------------------------------------

def _scripted_life(side) -> list:
    """Two switches with fixed node keys and a P2PMetrics each: connect,
    a message each way, then the dialler stops the peer for an error ->
    the dialler's and the acceptor's exposition before and after."""
    g = rng(18)
    regs, switches, reactors = [], [], []
    for i in range(2):
        nk = side["key"].NodeKey(side["ed"].priv_key_from_secret(g.bytes(32)))
        ni = side["node_info"].NodeInfo(node_id=nk.id(), listen_addr="", network="net",
                                        channels=bytes([CH]), moniker=f"m{i}")
        reg = side["registry"]()
        sw = side["switch"].Switch(side["transport"].MultiplexTransport(ni, nk),
                                   mconn_config=side["conn"].MConnConfig(ping_interval=3600),
                                   metrics=side["metrics"].P2PMetrics(reg))
        r = _echo_reactor(side)
        sw.add_reactor("ECHO", r)
        sw.transport.listen(side["netaddr"].NetAddress(id="", host="127.0.0.1", port=0))
        sw.start()
        regs.append(reg)
        switches.append(sw)
        reactors.append(r)
    a, b = switches
    out = []
    try:
        assert a.dial_peer_with_address(b.transport.listen_addr)
        assert wait_for(lambda: b.peers.size() == 1 and all(
            p.is_running() for p in a.peers.copy() + b.peers.copy()))
        a.peers.copy()[0].send(CH, b"echo:" + g.bytes(1500))
        assert wait_for(lambda: len(reactors[1].received) == 1)
        b.peers.copy()[0].send(CH, b"echo:" + g.bytes(40))
        assert wait_for(lambda: len(reactors[0].received) == 1)
        out += [regs[0].expose(), regs[1].expose()]
        a.stop_peer_for_error(a.peers.copy()[0], "scripted")
        # the reactor hears of the removal after the peer's series are dropped
        assert wait_for(lambda: reactors[1].removed)
        out += [regs[0].expose(), regs[1].expose()]
    finally:
        _stop(a, b)
    return out


def test_p2p_metrics_exposition_equals_the_reference():
    got, want = _scripted_life(PORT), _scripted_life(REF)
    assert got == want
    assert "cometbft_p2p_message_send_bytes_total{" in got[0]
    assert "cometbft_p2p_peers 0" in got[2] and "peer_id=" not in got[2]


def test_the_port_imports_no_cryptography():
    code = ("import sys\n"
            "sys.modules['cryptography'] = None\nsys.modules['jax'] = None\n"
            "from cometbft_tpu_torch.p2p import test_util as U, Reactor\n"
            "from cometbft_tpu_torch.p2p.conn import ChannelDescriptor\n"
            "class R(Reactor):\n"
            "    def __init__(self):\n"
            "        super().__init__(name='r'); self.got = []\n"
            "    def get_channels(self):\n"
            "        return [ChannelDescriptor(id=5)]\n"
            "    def receive(self, env):\n"
            "        self.got.append(env.message)\n"
            "a, b = R(), R()\n"
            "sa = U.make_switch(reactors={'r': a}); sb = U.make_switch(reactors={'r': b})\n"
            "sa.start(); sb.start(); U.connect_switches(sa, sb)\n"
            "sa.peers.copy()[0].send(5, b'z' * 4000)\n"
            "import time; t = time.time()\n"
            "while not b.got and time.time() - t < 10: time.sleep(0.01)\n"
            "sa.stop(); sb.stop()\n"
            "assert b.got == [b'z' * 4000]\n"
            "assert not [m for m in sys.modules if m.startswith('cometbft_tpu.')]\n"
            "print('WIRE-OK')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "WIRE-OK" in proc.stdout


@pytest.mark.parametrize("side_name", ["port", "reference"])
def test_stop_with_a_peer_between_add_and_start(monkeypatch, side_name):
    """A switch stopped while one of its peers is published to the peer
    set but not yet started (its MConnection's receive thread made, not
    started): the port's ``stop()`` returns; the reference's raises the
    ``RuntimeError`` of joining a thread that never started (the port's
    departure in ``p2p/switch.py``)."""
    side = PORT if side_name == "port" else REF
    held, go = [], threading.Event()
    real = side["conn"].MConnection.on_start

    def on_start(self):
        # the window: the receive thread exists and has not started
        self._recv_thread = threading.Thread(target=lambda: None)
        held.append(self)
        go.wait(WAIT)
        real(self)

    monkeypatch.setattr(side["conn"].MConnection, "on_start", on_start)
    a = side["util"].make_switch(moniker="a")
    b = side["util"].make_switch(moniker="b")
    dialer = None
    try:
        a.start()
        b.start()
        dialer = threading.Thread(
            target=lambda: outcome(lambda: a.dial_peer_with_address(b.transport.listen_addr)),
            daemon=True)
        dialer.start()
        assert wait_for(lambda: any(p.mconn in held for p in a.peers.copy()))
        got = outcome(a.stop)
    finally:
        go.set()
        if dialer is not None:
            dialer.join(WAIT)
        for sw in (a, b):
            if sw.is_running():
                outcome(sw.stop)
    if side is PORT:
        assert got == ("ok",)
    else:
        assert got == ("RuntimeError", "cannot join thread before it is started")
