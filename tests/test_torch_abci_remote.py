"""The port's out-of-process ABCI (cometbft_tpu_torch/abci: the codec's
request/response envelopes, server.py, client.py, grpc.py, grammar.py;
proxy/'s remote creators, ``default_client_creator`` and ``AppConns``'
error watcher; the trust guard's ``abci_response`` seam) against the
reference's (cometbft_tpu/...), which imports no jax for these modules.

Inputs are made with numpy from a seed.  Tolerance: exact -- envelope
bytes both ways; every method's response bytes with one package's
client against the other's server, over a unix socket, TCP and gRPC,
beside the same app called in process; a refusal's exception class and
message; the grammar checker's verdicts and the recorded calls.  One
test runs a port validator (``device="cpu"``) whose app is a child
process (``python -m cometbft_tpu_torch.abci.server``).  Every wait is
bounded."""

import dataclasses
import enum
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from cometbft_tpu import proxy as rproxy
from cometbft_tpu.abci import client as rclient
from cometbft_tpu.abci import codec as rcodec
from cometbft_tpu.abci import grammar as rgrammar
from cometbft_tpu.abci import grpc as rgrpc
from cometbft_tpu.abci import kvstore as rkv
from cometbft_tpu.abci import server as rserver
from cometbft_tpu.abci import types as rabci
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import trustguard as rtg
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch import proxy as pproxy
from cometbft_tpu_torch.abci import client as pclient
from cometbft_tpu_torch.abci import codec as pcodec
from cometbft_tpu_torch.abci import grammar as pgrammar
from cometbft_tpu_torch.abci import grpc as pgrpc
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import server as pserver
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.types import params as pparams
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import metrics as pumetrics
from cometbft_tpu_torch.utils import trustguard as ptg
from tests.test_torch_abci import _params
from tests.test_torch_types import outcome, rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60.0         # every wait's bound (the runs take seconds)
T0 = 1_700_000_000_123_456_789

REF = dict(abci=rabci, codec=rcodec, kv=rkv, db=rdb, server=rserver, client=rclient,
           grpc=rgrpc, proxy=rproxy, grammar=rgrammar, tg=rtg)
PORT = dict(abci=pabci, codec=pcodec, kv=pkv, db=pdb, server=pserver, client=pclient,
            grpc=pgrpc, proxy=pproxy, grammar=pgrammar, tg=ptg)


# -- values of the reference's types, and their twins in the port --------------

def _fill(cls, g):
    """A reference ``cls`` with every field of its wire spec set from ``g``."""
    kw = {}
    for _, attr, kind, sub in rcodec._SPEC[cls]:
        if kind == "validator":
            kw[attr[0]], kw[attr[1]] = g.bytes(20), int(g.integers(1, 1 << 40))
        elif kind == "str":
            kw[attr] = g.bytes(int(g.integers(1, 6))).hex() + "é"
        elif kind == "bytes":
            kw[attr] = g.bytes(int(g.integers(1, 40)))
        elif kind == "int":
            kw[attr] = int(g.integers(-(1 << 40), 1 << 40))
        elif kind == "bool":
            kw[attr] = True
        elif kind == "enum":
            kw[attr] = list(sub)[int(g.integers(0, len(sub)))]
        elif kind == "time":
            kw[attr] = int(g.integers(1, 1 << 62))
        elif kind == "dur":
            kw[attr] = int(g.integers(1, 10**12))
        elif kind == "msg":
            kw[attr] = _fill(sub, g)
        elif kind == "params":
            kw[attr] = _params(rabci, g)
        elif kind == "proofops":
            kw[attr] = tuple(_fill(rabci.ProofOp, g) for _ in range(2))
        elif kind == "rep_bytes":
            kw[attr] = tuple(g.bytes(int(g.integers(0, 30))) for _ in range(3))
        elif kind == "rep_str":
            kw[attr] = tuple(g.bytes(3).hex() for _ in range(2))
        elif kind == "rep_int":
            kw[attr] = tuple(int(x) for x in g.integers(-5, 1 << 40, 3))
        elif kind == "rep_msg":
            kw[attr] = tuple(_fill(sub, g) for _ in range(2))
    return cls(**kw)


_PORT_TYPES = {name: obj for mod in (pabci, pcodec, pparams) for name, obj in vars(mod).items()
               if isinstance(obj, type)}


def _port(v):
    """The port's twin of a reference value."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _PORT_TYPES[type(v).__name__](
            **{f.name: _port(getattr(v, f.name)) for f in dataclasses.fields(v)})
    if isinstance(v, enum.Enum):
        return getattr(pabci, type(v).__name__)(v.value)
    if isinstance(v, tuple):
        return tuple(_port(x) for x in v)
    return v


def _norm(v):
    """A value of either package as nested tuples (type names, ints)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(_norm(getattr(v, f.name))
                                           for f in dataclasses.fields(v))
    if isinstance(v, enum.Enum):
        return int(v.value)
    if isinstance(v, tuple):
        return tuple(_norm(x) for x in v)
    return v


# -- the envelopes -------------------------------------------------------------

ENVELOPES = ([("request", no, cls) for no, cls in rcodec._REQUEST_ONEOF]
             + [("response", no, cls) for no, cls in rcodec._RESPONSE_ONEOF])


@pytest.mark.parametrize("side,no,cls", ENVELOPES,
                         ids=[f"{s}-{c.__name__}" for s, _, c in ENVELOPES])
def test_envelope_bytes_equal_the_reference(side, no, cls):
    """Every request and response type with every wire field set: the
    port's envelope bytes are the reference's, and each package decodes
    the other's bytes to the same value."""
    g = rng(9400 + no + (50 if side == "response" else 0))
    r = _fill(cls, g)
    p = _port(r)
    renc, rdec = getattr(rcodec, f"encode_{side}"), getattr(rcodec, f"decode_{side}")
    penc, pdec = getattr(pcodec, f"encode_{side}"), getattr(pcodec, f"decode_{side}")
    rb = renc(r)
    assert penc(p) == rb
    assert _norm(pdec(rb)) == _norm(rdec(rb))
    assert penc(pdec(rb)) == rb and renc(rdec(penc(p))) == rb
    # the other table refuses it alike
    other = "response" if side == "request" else "request"
    assert outcome(lambda: getattr(pcodec, f"encode_{other}")(p))[0] == \
        outcome(lambda: getattr(rcodec, f"encode_{other}")(r))[0]


MALFORMED_ENVELOPES = [b"", b"\x0a", b"\x0a\x05ab", b"\x08\x01", b"\xfa\x01\x00",
                       b"\x1a\x02\x08", b"\x42\x03\x0a\x01\xff", b"\xa2\x01\x02\x12\x00",
                       b"\x1a\x03\x0a\x01\x80", b"\x0a\x01\x0a\x01", b"\x3a\x02\x10\xff"]


@pytest.mark.parametrize("raw", MALFORMED_ENVELOPES)
@pytest.mark.parametrize("side", ("request", "response"))
def test_malformed_envelopes_are_refused_alike(side, raw):
    assert outcome(lambda: getattr(pcodec, f"decode_{side}")(raw)) == \
        outcome(lambda: getattr(rcodec, f"decode_{side}")(raw))


# -- the socket protocol -------------------------------------------------------

def _calls(g) -> list:
    """One stream of calls to a kvstore app, in the reference's types:
    (method, argument) with None for a method without one."""
    A = rabci
    h = g.bytes(32)
    vals = tuple(A.ValidatorUpdate("ed25519", g.bytes(32), p) for p in (10, 7))
    return [
        ("echo", "hello ABCI"), ("flush", None),
        ("info", A.InfoRequest(version="v1", block_version=11, p2p_version=8,
                               abci_version="2.0.0")),
        ("init_chain", A.InitChainRequest(time_ns=T0, chain_id="remote", validators=vals,
                                          consensus_params=_params(A, g), initial_height=1)),
        ("check_tx", A.CheckTxRequest(tx=b"a=1")), ("check_tx", A.CheckTxRequest(tx=b"noequals")),
        ("check_tx", A.CheckTxRequest(tx=b"\xff=1", type=1)),
        ("prepare_proposal", A.PrepareProposalRequest(max_tx_bytes=1 << 20,
                                                      txs=(b"a=1", b"b=2", b"bad"), height=1,
                                                      time_ns=T0)),
        ("process_proposal", A.ProcessProposalRequest(txs=(b"a=1", b"b=2"), hash=h, height=1,
                                                      time_ns=T0)),
        ("process_proposal", A.ProcessProposalRequest(txs=(b"bad",), hash=h, height=1)),
        ("extend_vote", A.ExtendVoteRequest(hash=h, height=1, time_ns=T0)),
        ("verify_vote_extension", A.VerifyVoteExtensionRequest(
            hash=h, validator_address=g.bytes(20), height=1, vote_extension=b"x")),
        ("finalize_block", A.FinalizeBlockRequest(txs=(b"a=1", b"b=2", b"c=" + g.bytes(4).hex()
                                                       .encode()), hash=h, height=1,
                                                  time_ns=T0, decided_last_commit=A.CommitInfo())),
        ("commit", None),
        ("query", A.QueryRequest(data=b"a", path="/key", prove=True)),
        ("query", A.QueryRequest(data=b"zz")), ("query", A.QueryRequest(path="/height")),
        ("list_snapshots", None),
        ("load_snapshot_chunk", A.LoadSnapshotChunkRequest(height=1, format=1, chunk=0)),
        ("offer_snapshot", A.OfferSnapshotRequest(snapshot=A.Snapshot(height=1, format=1,
                                                                      chunks=1, hash=h),
                                                  app_hash=h)),
        ("apply_snapshot_chunk", A.ApplySnapshotChunkRequest(index=0, chunk=b"junk", sender="p")),
        ("info", A.InfoRequest()),
    ]


def _call(target, method: str, arg):
    fn = getattr(target, method)
    return fn() if arg is None else fn(arg)


def _bytes(side: dict, resp):
    """A response as comparable bytes (echo's string, flush's None as is)."""
    if resp is None or isinstance(resp, str):
        return resp
    return side["codec"].encode_msg(resp)


def _app(side: dict, cls=None):
    return (cls or side["kv"].KVStoreApp)(side["db"].MemDB(), snapshot_interval=1)


def _twin(side: dict, calls: list) -> list:
    """``calls`` on an in-process app of ``side``: the responses' bytes."""
    app = _app(side)
    out = []
    for method, arg in calls:
        if method == "echo":
            out.append(arg)
        elif method == "flush":
            out.append(None)
        else:
            out.append(_bytes(side, _call(app, method, arg)))
    return out


def _addr(transport: str, tmp_path) -> str:
    return f"unix://{tmp_path}/app.sock" if transport == "unix" else "tcp://127.0.0.1:0"


DIRECTIONS = {"port client, reference server": (PORT, REF),
              "reference client, port server": (REF, PORT)}


@pytest.mark.parametrize("transport", ("unix", "tcp"))
@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_every_method_over_the_socket_equals_the_app_in_process(direction, transport, tmp_path):
    """One package's SocketClient against the other's SocketServer: every
    ABCI method's response is, byte for byte, the one the server's app
    gives in process to the same stream of calls."""
    client_side, server_side = DIRECTIONS[direction]
    calls = _calls(rng(9500))
    srv = server_side["server"].SocketServer(_addr(transport, tmp_path), _app(server_side))
    srv.start()
    cli = client_side["client"].SocketClient(srv.listen_addr, connect_timeout=WAIT)
    try:
        cli.ensure_connected()
        got = [_bytes(client_side, _call(cli, m, arg if client_side is REF else _port(arg)))
               for m, arg in calls]
    finally:
        cli.close()
        srv.stop()
    assert got == _twin(server_side, [(m, arg if server_side is REF else _port(arg))
                                      for m, arg in calls])
    assert cli.error() is None


@pytest.mark.parametrize("server_pkg", ("reference", "port"))
def test_four_connections_share_one_app(server_pkg, tmp_path):
    """The port's AppConns over ``default_client_creator``'s socket
    clients: four connections to one server, CheckTx on the mempool
    connection from threads while the consensus connection finalizes a
    block; the query connection then reads what the block wrote."""
    side = REF if server_pkg == "reference" else PORT
    srv = side["server"].SocketServer(f"unix://{tmp_path}/app.sock", _app(side))
    srv.start()
    conns = pproxy.new_app_conns(pproxy.default_client_creator(srv.listen_addr))
    conns.start()
    try:
        deadline = time.monotonic() + WAIT
        while len(srv._conns) < 4:
            assert time.monotonic() < deadline, len(srv._conns)
            time.sleep(0.01)
        conns.consensus.init_chain(pabci.InitChainRequest(chain_id="four"))
        codes: list = []

        def admit(i: int) -> None:
            for j in range(10):
                codes.append(conns.mempool.check_tx(
                    pabci.CheckTxRequest(tx=b"t%d-%d=v" % (i, j))).code)

        threads = [threading.Thread(target=admit, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        resp = conns.consensus.finalize_block(pabci.FinalizeBlockRequest(
            txs=(b"four=4",), height=1, decided_last_commit=pabci.CommitInfo()))
        conns.consensus.commit()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert codes == [0] * 30 and resp.tx_results[0].code == 0
        q = conns.query.query(pabci.QueryRequest(data=b"four"))
        assert q.value == b"4" and q.height == 1
        assert conns.query.info(pabci.InfoRequest()).last_block_app_hash == resp.app_hash
        assert [s.height for s in conns.snapshot.list_snapshots().snapshots] == [1]
        assert len(srv._conns) == 4
    finally:
        conns.stop()
        srv.stop()


class _Boom:
    """A kvstore whose CheckTx raises."""

    @staticmethod
    def of(side: dict):
        class BoomApp(side["kv"].KVStoreApp):
            def check_tx(self, req):
                raise RuntimeError("boom")

        return BoomApp


def _latch_script(side: dict, tmp_path) -> list:
    srv = side["server"].SocketServer(f"unix://{tmp_path}/{id(side)}.sock",
                                      _app(side, _Boom.of(side)))
    srv.start()
    cli = side["client"].SocketClient(srv.listen_addr, connect_timeout=WAIT)
    A = side["abci"]
    out = []
    try:
        out.append(outcome(lambda: cli.info(A.InfoRequest())))
        out.append(outcome(lambda: cli.check_tx(A.CheckTxRequest(tx=b"a=1"))))
        out.append(repr(cli.error()))
        out.append(outcome(lambda: cli.info(A.InfoRequest())))
    finally:
        cli.close()
    out.append(outcome(lambda: cli.info(A.InfoRequest())))
    # a server that goes away: the next call fails and latches
    cli2 = side["client"].SocketClient(srv.listen_addr, connect_timeout=WAIT)
    cli2.ensure_connected()
    srv.stop()
    out.append(outcome(lambda: cli2.echo("x"))[0])
    out.append(type(cli2.error()).__name__)
    out.append(outcome(lambda: cli2.echo("x")))
    cli2.close()
    # nothing listens: the connect retry gives up at its deadline
    t = time.monotonic()
    cli3 = side["client"].SocketClient(f"unix://{tmp_path}/nothing.sock", connect_timeout=0.3)
    out.append(outcome(cli3.ensure_connected)[0])
    out.append(time.monotonic() - t < 5.0)
    return out


def test_the_client_latches_its_first_error_alike(tmp_path):
    """An app exception (a ResponseException on the wire), then a closed
    client, a server gone away and one never there: the same outcomes,
    classes and messages (the transport's own errors by class)."""
    got = _latch_script(PORT, tmp_path)
    want = _latch_script(REF, tmp_path)
    assert got[1] == ("AbciClientError", "app exception: RuntimeError('boom')")
    assert got[3][1].startswith("abci client is dead: app exception")
    assert got[4] == ("AbciClientError", "abci client is dead: app exception: RuntimeError('boom')")
    assert got[-2] == "AbciClientError" and got[-1] is True
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert got[2] == want[2].replace("cometbft_tpu.proxy", "cometbft_tpu_torch.proxy")


@pytest.mark.parametrize("pkg", ("reference", "port"))
def test_the_watcher_fires_once_when_the_server_goes_away(pkg, tmp_path):
    """AppConns over remote clients polls their latched errors: when the
    server goes away and two connections fail, ``on_error`` fires once,
    within the watcher's poll, in both packages."""
    side = REF if pkg == "reference" else PORT
    srv = side["server"].SocketServer(f"unix://{tmp_path}/app.sock", _app(side))
    srv.start()
    conns = side["proxy"].new_app_conns(side["proxy"].default_client_creator(srv.listen_addr))
    fired: list = []
    conns.set_on_error(fired.append)
    conns.start()
    try:
        assert conns.query.info(side["abci"].InfoRequest()).last_block_height == 0
        srv.stop()
        t = time.monotonic()
        for c in (conns.mempool, conns.consensus):
            assert outcome(lambda: c.check_tx(side["abci"].CheckTxRequest(tx=b"a=1")))[0] == \
                "AbciClientError"
        while not fired and time.monotonic() - t < 5.0:
            time.sleep(0.01)
        assert len(fired) == 1, "on_error did not fire within 5 s"
        time.sleep(1.2)      # one more poll of the watcher
        assert len(fired) == 1
    finally:
        conns.stop()
    assert conns._watcher is not None
    conns._watcher.join(WAIT)
    assert not conns._watcher.is_alive()


@pytest.mark.parametrize("armed", (True, False))
def test_the_abci_response_seam_trips_on_an_unvalidated_response(armed, tmp_path, monkeypatch):
    """A response read by the socket client is wire-derived: a sink
    reached while it is decoded, with no validator run, trips the guard
    (the client latches the TrustGuardError) when the guard is armed,
    in both packages; a plain round trip never trips."""
    out = {}
    for pkg, side in (("ref", REF), ("port", PORT)):
        tg, codec = side["tg"], side["codec"]
        reg = pumetrics.Registry()
        tg.reset(enable=armed)
        tg.install_metrics(pmetrics.ConsensusMetrics(reg))
        srv = side["server"].SocketServer(f"unix://{tmp_path}/{pkg}.sock", _app(side))
        srv.start()
        cli = side["client"].SocketClient(srv.listen_addr, connect_timeout=WAIT)
        try:
            plain = outcome(lambda: cli.info(side["abci"].InfoRequest()))
            decode = codec.decode_response

            def sinking(raw, decode=decode, tg=tg):
                tg.check_sink("apply_block")
                return decode(raw)

            monkeypatch.setattr(codec, "decode_response", sinking)
            tripped = outcome(lambda: cli.info(side["abci"].InfoRequest()))
            out[pkg] = (plain, tripped[0], type(cli.error()).__name__,
                        reg.expose().count('trust_guard_trips_total{sink="apply_block"} 1'))
        finally:
            monkeypatch.undo()
            cli.close()
            srv.stop()
            tg.install_metrics(None)
            tg.reset(enable=False)
    assert out["port"] == out["ref"]
    if armed:
        assert out["port"] == (("ok",), "AbciClientError", "TrustGuardError", 1)
    else:
        assert out["port"] == (("ok",), "ok", "NoneType", 0)


# -- gRPC ----------------------------------------------------------------------

@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_every_method_over_grpc_equals_the_app_in_process(direction):
    """One package's GrpcClient against the other's GrpcServer
    (``cometbft.abci.v1.ABCIService``): the same responses as the
    server's app in process; an app exception aborts the call, and the
    client raises and latches it alike."""
    client_side, server_side = DIRECTIONS[direction]
    calls = _calls(rng(9501))
    srv = server_side["grpc"].GrpcServer(_app(server_side), "127.0.0.1:0")
    srv.start()
    cli = client_side["grpc"].GrpcClient(f"grpc://127.0.0.1:{srv.port}", connect_timeout=WAIT)
    try:
        got = [_bytes(client_side, _call(cli, m, arg if client_side is REF else _port(arg)))
               for m, arg in calls]
        assert cli.error() is None
    finally:
        cli.close()
        srv.stop()
    assert got == _twin(server_side, [(m, arg if server_side is REF else _port(arg))
                                      for m, arg in calls])
    # an app that raises: INTERNAL, raised and latched by the client
    srv = server_side["grpc"].GrpcServer(_app(server_side, _Boom.of(server_side)), "127.0.0.1:0")
    srv.start()
    cli = client_side["grpc"].GrpcClient(f"grpc://127.0.0.1:{srv.port}", connect_timeout=WAIT)
    A = client_side["abci"]
    try:
        assert outcome(lambda: cli.check_tx(A.CheckTxRequest(tx=b"a=1")))[0] == "AbciClientError"
        assert "boom" in str(cli.error())
    finally:
        cli.close()
        srv.stop()


# -- routing -------------------------------------------------------------------

ADDRS = ["grpc://127.0.0.1:26658", "tcp://127.0.0.1:26658", "unix:///tmp/app.sock", "kvstore",
         "noop", ""]


@pytest.mark.parametrize("with_app", (True, False))
@pytest.mark.parametrize("addr", ADDRS)
def test_default_client_creator_routes_as_the_reference(addr, with_app):
    """``proxy_app`` -> creator and client: the same classes, or the
    same refusal; a remote client connects only when asked."""
    def route(side):
        app = side["kv"].KVStoreApp() if with_app else None
        try:
            creator = side["proxy"].default_client_creator(addr, app)
        except Exception as exc:  # noqa: BLE001 -- compared
            return type(exc).__name__, str(exc)
        client = creator.new_client()
        return type(creator).__name__, type(client).__name__

    assert route(PORT) == route(REF)


# -- the call grammar ----------------------------------------------------------

#: tests/test_e2e_perturb.py's sequences (TestAbciGrammar): (calls, clean start)
E2E_GRAMMAR = [
    ([("init_chain", 1), ("process_proposal", 0), ("finalize_block", 1), ("commit", 0),
      ("prepare_proposal", 0), ("process_proposal", 0), ("finalize_block", 2), ("commit", 0)],
     True),
    ([("finalize_block", 7), ("commit", 0)], False),
    ([("offer_snapshot", 0), ("apply_snapshot_chunk", 0), ("apply_snapshot_chunk", 0),
      ("finalize_block", 101), ("commit", 0)], True),
    ([("init_chain", 1), ("finalize_block", 1)], True),
    ([("finalize_block", 1), ("commit", 0)], True),
    ([("init_chain", 1), ("finalize_block", 1), ("commit", 0)], False),
    ([("init_chain", 1), ("commit", 0)], True),
    ([("init_chain", 1), ("finalize_block", 1), ("commit", 0), ("finalize_block", 3),
      ("commit", 0)], True),
    ([("init_chain", 1), ("finalize_block", 1), ("commit", 0), ("commit", 0)], True),
]

_VOCAB = ["init_chain", "prepare_proposal", "process_proposal", "extend_vote",
          "verify_vote_extension", "finalize_block", "commit", "offer_snapshot",
          "apply_snapshot_chunk"]


def _random_grammar(case: int) -> tuple:
    """A run of heights from a seed, mutated at one point half the time."""
    g = rng(9600 + case)
    clean = bool(case % 2)
    calls = [("init_chain", 1)] if clean else []
    for h in range(1, int(g.integers(1, 6)) + 1):
        calls += [(str(g.choice(_VOCAB[1:5])), 0) for _ in range(int(g.integers(0, 3)))]
        calls += [("finalize_block", h), ("commit", 0)]
    if case % 4 >= 2 and calls:
        i = int(g.integers(0, len(calls)))
        kind = int(g.integers(0, 3))
        if kind == 0:
            del calls[i]
        elif kind == 1:
            calls.insert(i, (str(g.choice(_VOCAB)), int(g.integers(0, 7))))
        else:
            calls[i] = (calls[i][0], calls[i][1] + 1)
    return calls, clean


GRAMMAR_CASES = E2E_GRAMMAR + [_random_grammar(i) for i in range(24)] + [([], True), ([], False)]


@pytest.mark.parametrize("case", range(len(GRAMMAR_CASES)))
def test_check_grammar_decides_as_the_reference(case):
    calls, clean = GRAMMAR_CASES[case]
    got = outcome(lambda: pgrammar.check_grammar(list(calls), clean))
    assert got == outcome(lambda: rgrammar.check_grammar(list(calls), clean))
    if case < len(E2E_GRAMMAR):
        assert (got == ("ok",)) == (case < 4)


def test_recording_app_records_as_the_reference():
    """RecordingApp around each package's kvstore: the same tracked calls
    (names and heights) for one stream, none of the untracked ones; its
    consensus part passes ``check``, and the snapshot offer after a
    commit is refused alike; it is not an Application."""
    records, checks = [], []
    for side in (REF, PORT):
        rec = side["grammar"].RecordingApp(_app(side))
        for method, arg in _calls(rng(9502)):
            if method not in ("echo", "flush"):
                _call(rec, method, arg if side is REF else _port(arg))
            if method == "commit":
                rec.check(clean_start=True)
        checks.append(outcome(lambda: rec.check(clean_start=True)))
        records.append(list(rec.calls))
        assert not isinstance(rec, side["abci"].Application)
    assert records[0] == records[1]
    assert checks[0] == checks[1] and checks[1][0] == "GrammarError"
    assert [c[0] for c in records[1]] == [
        "init_chain", "prepare_proposal", "process_proposal", "process_proposal", "extend_vote",
        "verify_vote_extension", "finalize_block", "commit", "offer_snapshot",
        "apply_snapshot_chunk"]


# -- a validator whose app is another process ----------------------------------

def test_a_port_validator_commits_with_its_app_in_a_child(tmp_path):
    """One port validator (``device="cpu"``) whose kvstore app is a child
    process, ``python -m cometbft_tpu_torch.abci.server``, reached through
    ``default_client_creator``: it commits 3 heights with txs, the calls
    on its consensus connection follow the ABCI grammar from a clean
    start, and the app's Info carries the node's app hash."""
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.consensus import ConsensusState, Handshaker
    from cometbft_tpu_torch.crypto import ed25519 as ped
    from cometbft_tpu_torch.mempool import CListMempool
    from cometbft_tpu_torch.privval import FilePV
    from cometbft_tpu_torch.state import Store, load_state_from_db_or_genesis
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.event_bus import EventBus
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.utils.log import NopLogger

    addr = f"unix://{tmp_path}/app.sock"
    child = subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.abci.server", "--app", "kvstore", "--addr",
         addr], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    services = []
    try:
        pv = FilePV(ped.priv_key_from_secret(b"remote-app-validator"))
        gen = GenesisDoc(chain_id="remote-app", genesis_time_ns=T0,
                         validators=(GenesisValidator(pv.pub_key, 10),))
        blocks, states = BlockStore(pdb.MemDB()), Store(pdb.MemDB())
        conns = pproxy.new_app_conns(pproxy.default_client_creator(addr))
        rec = pgrammar.RecordingApp(conns.consensus)
        conns.consensus = rec
        conns.start()        # the socket client's connect retry covers the child's start
        services.append(conns)
        bus = EventBus()
        bus.start()
        services.append(bus)
        state = load_state_from_db_or_genesis(states, gen)
        mempool = CListMempool(conns.mempool, height=state.last_block_height, device="cpu")
        ex = BlockExecutor(states, conns.consensus, mempool, block_store=blocks, event_bus=bus,
                           logger=NopLogger(), device="cpu")
        state = Handshaker(states, state, blocks, gen, logger=NopLogger(),
                           device="cpu").handshake(conns)
        txs = [b"child%d=%d" % (i, i) for i in range(6)]
        assert [mempool.check_tx(tx).code for tx in txs] == [0] * 6
        cs = ConsensusState(test_config().consensus, state, ex, blocks, priv_validator=pv,
                            event_bus=bus, logger=NopLogger(), device="cpu")
        cs.start()
        services.append(cs)
        deadline = time.monotonic() + WAIT
        while cs.state.last_block_height < 3:
            assert time.monotonic() < deadline, blocks.height()
            time.sleep(0.01)
        cs.stop()
        rec.check(clean_start=True)
        assert [c[0] for c in rec.calls[:1]] == ["init_chain"]
        assert sum(1 for c in rec.calls if c[0] == "commit") >= 3
        info = conns.query.info(pabci.InfoRequest())
        assert (info.last_block_height, info.last_block_app_hash) == \
            (cs.state.last_block_height, cs.state.app_hash)
        committed = [tx for h in range(1, blocks.height() + 1)
                     for tx in blocks.load_block(h).data.txs]
        assert sorted(committed) == sorted(txs)
        q = conns.query.query(pabci.QueryRequest(data=b"child5"))
        assert q.value == b"5"
    finally:
        for svc in reversed(services):
            svc.stop()
        os.killpg(child.pid, signal.SIGTERM)
        try:
            child.wait(10)
        except subprocess.TimeoutExpired:
            os.killpg(child.pid, signal.SIGKILL)
            child.wait(5)
    assert child.returncode == 0
