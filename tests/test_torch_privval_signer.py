"""The port's remote signer (cometbft_tpu_torch/privval/signer.py:
``SignerClient``, ``SignerListenerEndpoint``, ``SignerServer``) against
the reference's (cometbft_tpu/privval/signer.py), which imports no jax.

Each package's client talks to the other's server over a unix socket or
TCP.  Tolerance: exact -- the pub key, the signed votes' and proposals'
bytes (equal to a local FilePV's, Ed25519 being deterministic), the
wire's frames, the state file, a refusal's class and message.  Last,
chip_smoke's run (r) at 1 + 3 validators on ``device="cpu"``: the app
and the signer (``python -m cometbft_tpu_torch.privval.signer``) as
child processes.  Every wait is bounded."""

import json
import socket

import pytest

from cometbft_tpu.crypto import ed25519 as red
from cometbft_tpu.privval import FilePV as RFilePV
from cometbft_tpu.privval import signer as rsigner
from cometbft_tpu.types import PRECOMMIT_TYPE, PREVOTE_TYPE
from cometbft_tpu.types import vote as rvote
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.privval import FilePV as PFilePV
from cometbft_tpu_torch.privval import signer as psigner
from cometbft_tpu_torch.types import vote as pvote
from tests.helpers import make_block_id
from tests.test_torch_types import outcome, rng

CHAIN = "signer-parity"
WAIT = 30.0         # every wait's bound

REF = dict(ed=red, pv=RFilePV, signer=rsigner, vote=rvote)
PORT = dict(ed=ped, pv=PFilePV, signer=psigner, vote=pvote)
DIRECTIONS = {"port client, reference signer": (PORT, REF),
              "reference client, port signer": (REF, PORT)}


def _pair(client_side: dict, server_side: dict, addr: str, pv=None, chain: str = CHAIN,
          **endpoint_kw):
    """A started listener of ``client_side``, a ``server_side`` signer
    dialled in to it with ``pv``, and a SignerClient over the listener."""
    pv = pv or server_side["pv"](server_side["ed"].priv_key_from_secret(b"remote-signer"))
    ep = client_side["signer"].SignerListenerEndpoint(addr, CHAIN, accept_timeout=WAIT,
                                                      **endpoint_kw)
    ep.start()
    srv = server_side["signer"].SignerServer(ep.listen_addr, chain, pv, retry_interval=0.05)
    srv.start()
    assert ep.wait_for_signer(WAIT), "the signer never dialled in"
    return pv, ep, srv, client_side["signer"].SignerClient(ep)


def _stop(ep, srv) -> None:
    srv.stop()
    ep.stop()


def _addr(transport: str, tmp_path) -> str:
    return f"unix://{tmp_path}/pv.sock" if transport == "unix" else "tcp://127.0.0.1:0"


def _votes(g, address: bytes, h0: int = 1) -> list:
    """Reference votes and proposals for one validator at heights h0 ... h0 + 3."""
    out = []
    for h in range(h0, h0 + 4):
        bid = make_block_id(g.bytes(8))
        ts = 1_700_000_000_000_000_000 + int(g.integers(0, 10**9))
        out.append(rvote.Proposal(height=h, round=0, pol_round=-1, block_id=bid, timestamp_ns=ts))
        for t in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            out.append(rvote.Vote(type=t, height=h, round=0, block_id=bid, timestamp_ns=ts,
                                  validator_address=address, validator_index=2))
    return out


def _sign(client, side: dict, msg):
    """``msg`` (a reference vote or proposal) through ``client`` in
    ``side``'s types -> the signed message's bytes."""
    if isinstance(msg, rvote.Proposal):
        return client.sign_proposal(CHAIN, side["vote"].Proposal.decode(msg.encode())).encode()
    return client.sign_vote(CHAIN, side["vote"].Vote.decode(msg.encode())).encode()


@pytest.mark.parametrize("transport", ("unix", "tcp"))
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_signatures_through_the_other_package_equal_a_local_file_pv(direction, transport,
                                                                    tmp_path):
    """The pub key, then votes and proposals at rising heights signed
    through one package's client by the other's signer: byte for byte
    what a local reference FilePV of the same key signs."""
    client_side, server_side = DIRECTIONS[direction]
    pv, ep, srv, client = _pair(client_side, server_side, _addr(transport, tmp_path))
    local = RFilePV(red.priv_key_from_secret(b"remote-signer"))
    try:
        assert client.pub_key.bytes() == local.pub_key.bytes()
        assert client.address == local.address
        for msg in _votes(rng(9700), local.address):
            want = (local.sign_proposal(CHAIN, msg) if isinstance(msg, rvote.Proposal)
                    else local.sign_vote(CHAIN, msg)).encode()
            assert _sign(client, client_side, msg) == want
    finally:
        _stop(ep, srv)


def _refusals(client_side: dict, server_side: dict, addr: str) -> list:
    pv, ep, srv, client = _pair(client_side, server_side, addr)
    vote_mod = client_side["vote"]
    a, b = make_block_id(b"a"), make_block_id(b"b")
    v1 = vote_mod.Vote(type=PRECOMMIT_TYPE, height=7, round=0, block_id=a, timestamp_ns=1,
                       validator_address=pv.address, validator_index=0)
    out = []
    try:
        out.append(outcome(lambda: client.sign_vote(CHAIN, v1)))
        v2 = vote_mod.Vote(type=PRECOMMIT_TYPE, height=7, round=0, block_id=b, timestamp_ns=2,
                           validator_address=pv.address, validator_index=0)
        out.append(outcome(lambda: client.sign_vote(CHAIN, v2)))
        # a lower height than the last signed: refused by the signer's state
        v0 = vote_mod.Vote(type=PRECOMMIT_TYPE, height=6, round=0, block_id=a, timestamp_ns=1,
                           validator_address=pv.address, validator_index=0)
        out.append(outcome(lambda: client.sign_vote(CHAIN, v0)))
        prop = vote_mod.Proposal(height=7, round=0, pol_round=-1, block_id=b, timestamp_ns=3)
        out.append(outcome(lambda: client.sign_proposal(CHAIN, prop)))
        # the signer serves its own chain only
        out.append(outcome(lambda: client.sign_vote("other-chain", v1)))
        out.append(outcome(lambda: client.sign_proposal("other-chain", prop)))
        # the refused request left the connection usable
        out.append(ep.request(7, b""))
        out.append(dict(getattr(srv, "served", {})))
    finally:
        _stop(ep, srv)
    return out


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_refusals_cross_the_wire_with_the_references_messages(direction, tmp_path):
    """A conflicting vote at one height/round/step, a lower height, a
    proposal after the precommit and another chain id: each refused by
    the signer, next to the key, with the message a reference signer
    sends to a reference client."""
    got = _refusals(*DIRECTIONS[direction], f"unix://{tmp_path}/pv.sock")
    want = _refusals(REF, REF, f"unix://{tmp_path}/ref.sock")
    assert got[:-1] == want[:-1]
    assert got[0] == ("ok",) and got[1][0] == "RemoteSignerError" and "conflicting" in got[1][1]
    assert got[4][1] == "chain id mismatch: signer serves 'signer-parity', got 'other-chain'"
    assert got[6] == (8, b"")
    if DIRECTIONS[direction][1] is PORT:
        assert got[-1] == {"vote": 1, "refused": 5, "ping": 1}


def test_the_references_key_files_are_served_by_the_port_signer(tmp_path):
    """The reference's priv_validator_key.json and _state.json, loaded by
    the port's FilePV behind the port's signer: its signatures are the
    reference FilePV's, its double-sign guard remembers the reference's
    last signature, and the state file it writes is the reference's."""
    key, state = str(tmp_path / "priv_validator_key.json"), str(tmp_path / "state.json")
    ref_pv = RFilePV(red.priv_key_from_secret(b"file-signer"), key, state)
    ref_pv.save()
    first = rvote.Vote(type=PRECOMMIT_TYPE, height=3, round=0, block_id=make_block_id(b"x"),
                       timestamp_ns=5, validator_address=ref_pv.address, validator_index=1)
    ref_pv.sign_vote(CHAIN, first)        # the reference's last sign state: height 3
    twin = RFilePV.load(key, state)       # the reference's own continuation
    twin_state = str(tmp_path / "twin_state.json")
    twin._state_path = twin_state
    pv, ep, srv, client = _pair(REF, PORT, f"unix://{tmp_path}/pv.sock",
                                pv=PFilePV.load(key, state))
    try:
        assert client.pub_key.bytes() == ref_pv.pub_key.bytes()
        # the same vote again (same sign bytes): the stored signature back
        again = client.sign_vote(CHAIN, first)
        assert again.signature == ref_pv.sign_vote(CHAIN, first).signature
        conflicting = rvote.Vote(type=PRECOMMIT_TYPE, height=3, round=0,
                                 block_id=make_block_id(b"y"), timestamp_ns=6,
                                 validator_address=ref_pv.address, validator_index=1)
        assert outcome(lambda: client.sign_vote(CHAIN, conflicting)) == (
            "RemoteSignerError", str(outcome(lambda: twin.sign_vote(CHAIN, conflicting))[1]))
        for msg in _votes(rng(9701), ref_pv.address, h0=4):
            got = _sign(client, REF, msg)
            want = (twin.sign_proposal(CHAIN, msg) if isinstance(msg, rvote.Proposal)
                    else twin.sign_vote(CHAIN, msg)).encode()
            assert got == want
    finally:
        _stop(ep, srv)
    with open(state) as f, open(twin_state) as g:
        assert json.load(f) == json.load(g)


def test_frames_and_error_bodies_are_the_references():
    """The uvarint-framed envelopes (field numbers 1-8) and the error
    body (field 99), written by each package into a socket pair and
    read back by the other."""
    bodies = [(1, b"\x0a\x03abc"), (4, psigner._err_body("double sign")), (7, b""),
              (8, b""), (3, bytes(range(200)))]
    for no, body in bodies:
        frames = []
        for side, other in ((PORT, REF), (REF, PORT)):
            a, b = socket.socketpair()
            try:
                side["signer"]._send(a, no, body)
                a.shutdown(socket.SHUT_WR)
                raw = b.recv(1 << 16)
                frames.append(raw)
                c, d = socket.socketpair()
                c.sendall(raw)
                c.shutdown(socket.SHUT_WR)
                with d.makefile("rb") as f:
                    assert other["signer"]._recv(f) == (no, body)
                c.close()
                d.close()
            finally:
                a.close()
                b.close()
        assert frames[0] == frames[1]
    assert psigner._err_body("x") == rsigner._err_body("x")


@pytest.mark.parametrize("side", ("reference", "port"))
def test_ping_redial_and_the_accept_deadline(side, tmp_path):
    """Ping answers with field 8; a connection dropped under the
    listener is dialled again by the signer and the next request
    succeeds; with no signer, ``wait_for_signer`` and a request give up
    at their deadlines."""
    s = REF if side == "reference" else PORT
    pv, ep, srv, client = _pair(s, s, f"unix://{tmp_path}/pv.sock")
    try:
        assert ep.request(7, b"") == (8, b"")
        ep._drop_conn()
        assert ep.wait_for_signer(WAIT)
        vote = s["vote"].Vote(type=PRECOMMIT_TYPE, height=9, round=0,
                              block_id=make_block_id(), timestamp_ns=1,
                              validator_address=pv.address, validator_index=0)
        assert client.sign_vote(CHAIN, vote).signature
    finally:
        _stop(ep, srv)
    lonely = s["signer"].SignerListenerEndpoint(f"unix://{tmp_path}/none.sock", CHAIN,
                                                accept_timeout=0.2)
    lonely.start()
    try:
        assert lonely.wait_for_signer(0.2) is False
        assert outcome(lambda: lonely.request(7, b"")) == (
            "RemoteSignerError", "no signer connected within accept deadline")
    finally:
        lonely.stop()


def test_the_smoke_remote_run_on_the_cpu(tmp_path):
    """chip_smoke's (r) at 1 + 3 validators, 4 heights, on
    ``device="cpu"``: the kvstore app (``APP_CHILD``) and the signer
    (``python -m cometbft_tpu_torch.privval.signer``) as child processes,
    the indexer, the pruner (retain the last 4 heights) and the trust
    guard; ``end_remote``'s checks pass, the node's signatures are the
    signer's on both ends, and no child outlives the run."""
    import torch

    import chip_smoke
    from cometbft_tpu_torch import config as C
    from cometbft_tpu_torch import metrics as M
    from cometbft_tpu_torch.utils.metrics import Registry

    reg = Registry()
    saved = M._CRYPTO
    M.install_crypto_metrics(M.CryptoMetrics(reg))
    try:
        r = chip_smoke.cs_stub_run(torch.device("cpu"), "remote on the cpu", reg, 3, 6, False,
                                   config=C.test_config(), remote="socket",
                                   work=str(tmp_path / "r"), ntx=12, timeout_s=WAIT)
    finally:
        M.install_crypto_metrics(saved)
    assert [row["height"] for row in r["per_height"]] == list(range(1, 7))
    assert all(row["sigs"] >= 3 for row in r["per_height"])
    e = r["remote"]
    assert e["pruned"]["retain"] == 2 and e["pruned"]["base"] == 2
    assert e["pruned"]["pruned_blocks"] == 1.0 and e["trips"] == 0
    assert e["probe"] == "AbciClientError" and e["on_error_s"] < chip_smoke.CS_APP_ERROR_S
    assert e["served"]["proposal"] >= 1 and e["served"]["vote"] >= 12
    assert set(r["abci"]) >= {"prepare_proposal", "process_proposal", "finalize_block", "commit"}
    assert not (tmp_path / "r").exists()
