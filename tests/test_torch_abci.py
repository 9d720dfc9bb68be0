"""The port's ABCI layer (cometbft_tpu_torch/abci: types, the codec of the
messages state execution stores, the kvstore app; mempool/ingest.py) and
its pub/sub (utils/pubsub.py) against the reference's (cometbft_tpu/...),
which imports no jax for these modules.

The same values, made from a seed with numpy, go to both packages.
Tolerance: exact -- codec bytes in both directions, ``results_hash``, the
kvstore's responses (compared as nested tuples), app hash and persisted
record after every request of one stream (validator txs, malformed ones,
signed envelopes, queries with proofs, snapshots), ``Query`` parsing and
matching, and the pub/sub server's deliveries and drops; a refusal is
the same exception class and message."""

import base64
from dataclasses import astuple

import pytest

from cometbft_tpu.abci import codec as rcodec
from cometbft_tpu.abci import kvstore as rkv
from cometbft_tpu.abci import types as rabci
from cometbft_tpu.mempool import ingest as ringest
from cometbft_tpu.types import params as rparams
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import pubsub as rpubsub
from cometbft_tpu_torch.abci import codec as pcodec
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.mempool import ingest as pingest
from cometbft_tpu_torch.types import params as pparams
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import pubsub as ppubsub
from tests.test_torch_types import outcome, ref_keys, rng


# -- the codec ---------------------------------------------------------------

def _params(mod, g):
    p = rparams.ConsensusParams()
    d = p.to_json_dict()
    d["block"]["max_bytes"] = str(int(g.integers(1 << 10, 1 << 22)))
    d["block"]["max_gas"] = "-1"
    d["feature"]["vote_extensions_enable_height"] = str(int(g.integers(0, 100)))
    d["feature"]["pbts_enable_height"] = "7"
    return (rparams if mod is rabci else pparams).ConsensusParams.from_json_dict(d)


def _events(mod, g, n):
    return tuple(mod.Event(type=f"ev{i}", attributes=tuple(
        mod.EventAttribute(key=f"k{j}", value=g.bytes(3).hex(), index=bool(j % 2))
        for j in range(int(g.integers(0, 3))))) for i in range(n))


def _messages(mod, tag: int):
    """The messages of case ``tag`` in ``mod``'s types, from one seed."""
    g = rng(9200 + tag)
    results = tuple(mod.ExecTxResult(
        code=int(g.integers(0, 3)), data=g.bytes(int(g.integers(0, 9))),
        log=["", "ok", "ünïcode"][i % 3], info="i" * (i % 2),
        gas_wanted=int(g.integers(-2, 5)), gas_used=int(g.integers(0, 1 << 40)),
        events=_events(mod, g, i % 3), codespace="cs" if i == 2 else "")
        for i in range(tag % 4 + 1))
    resp = mod.FinalizeBlockResponse(
        events=_events(mod, g, tag % 3),
        tx_results=results,
        validator_updates=tuple(mod.ValidatorUpdate("ed25519", g.bytes(32), p)
                                for p in (0, 10, -1)[: tag % 4]),
        consensus_param_updates=_params(mod, g) if tag % 2 else None,
        app_hash=g.bytes(32 * (tag % 2)),
        next_block_delay_ns=[0, 1_500_000_000, -7, 10**12][tag % 4])
    return [mod.ExecTxResult()] + list(results) + [mod.FinalizeBlockResponse(), resp]


@pytest.mark.parametrize("tag", range(4))
def test_codec_bytes_equal_the_reference(tag):
    for r, p in zip(_messages(rabci, tag), _messages(pabci, tag)):
        rb = r.encode()
        assert p.encode() == rb
        assert type(p).decode(rb).encode() == rb
        assert astuple(type(p).decode(rb)) == astuple(type(r).decode(rb))
        if isinstance(p, pabci.ExecTxResult):
            assert p.deterministic_encode() == r.deterministic_encode()


@pytest.mark.parametrize("n", (0, 1, 2, 7))
def test_results_hash_equals_the_reference(n):
    r = _messages(rabci, 3)[1:2] * n
    p = _messages(pabci, 3)[1:2] * n
    assert pabci.results_hash(p) == rabci.results_hash(r)


MALFORMED = [b"\x0a\x05abc", b"\x08", b"\x0a\x01\x08", b"\x12\x02\x08\x01", b"\x22\x01\xff",
             b"\x2a\x03\xff\xfe\xfd\x0a", b"\x32\x02\x08", b"\x0a\x02\x12\x01"]


@pytest.mark.parametrize("raw", MALFORMED)
@pytest.mark.parametrize("cls", ("ExecTxResult", "FinalizeBlockResponse"))
def test_malformed_messages_are_refused_alike(cls, raw):
    want = outcome(lambda: getattr(rabci, cls).decode(raw))
    got = outcome(lambda: getattr(pabci, cls).decode(raw))
    assert got == want


def test_codec_refuses_an_unknown_type_alike():
    assert outcome(lambda: pcodec.encode_msg(object()))[0] == \
        outcome(lambda: rcodec.encode_msg(object()))[0] == "AbciCodecError"


# -- the kvstore app -----------------------------------------------------------

def _stream(mod, ingest):
    """One stream of requests to a fresh app of ``mod`` (snapshots every
    2 heights) -> (per request: its name and response as nested tuples,
    and the persisted record and app hash after it)."""
    abci, kv, db_mod = mod
    g = rng(9300)
    keys = ref_keys(g, 4)
    vals = [k.pub_key().bytes() for k in keys[:3]]
    db = db_mod.MemDB()
    app = kv.KVStoreApp(db, snapshot_interval=2)
    env = ingest.make_signed_tx(keys[3], b"env=ok")
    txs = [b"a=1", b"b=" + g.bytes(6).hex().encode(), b"val:%s!10" % base64.b64encode(vals[0]),
           b"val:%s!0" % base64.b64encode(vals[1]), b"val:%s!-1" % base64.b64encode(vals[2]),
           b"val:short!1", b"val:nobang", b"\xff=1", b"noequals", env, env[:-1] + b"x",
           b"stx:00", b"a=2"]
    out = []

    def step(name, fn):
        resp = fn()
        out.append((name, astuple(resp) if resp is not None else None,
                    db.get(b"kvstore:state"), app.app_hash))

    step("info", lambda: app.info(abci.InfoRequest()))
    step("init_chain", lambda: app.init_chain(abci.InitChainRequest(validators=tuple(
        abci.ValidatorUpdate("ed25519", v, 10) for v in vals[1:]))))
    for i, tx in enumerate(txs):
        step(f"check_tx {i}", lambda: app.check_tx(abci.CheckTxRequest(tx=tx)))
    step("process good", lambda: app.process_proposal(abci.ProcessProposalRequest(
        txs=tuple(txs[:4]))))
    step("process bad", lambda: app.process_proposal(abci.ProcessProposalRequest(
        txs=tuple(txs))))
    for h, batch in ((1, txs[:7]), (2, txs[7:]), (3, [b"c=3"]), (4, [])):
        step(f"finalize {h}", lambda: app.finalize_block(abci.FinalizeBlockRequest(
            txs=tuple(batch), height=h)))
        step(f"commit {h}", lambda: app.commit())
    step("info 4", lambda: app.info(abci.InfoRequest()))
    for q in (abci.QueryRequest(data=b"a"), abci.QueryRequest(data=b"b", prove=True),
              abci.QueryRequest(data=b"missing", prove=True), abci.QueryRequest(path="/height"),
              abci.QueryRequest(data=b"\xff")):
        step(f"query {q.data!r} {q.path}", lambda: app.query(q))
    snaps = app.list_snapshots()
    step("list_snapshots", lambda: snaps)
    chunks = [app.load_snapshot_chunk(abci.LoadSnapshotChunkRequest(
        height=s.height, format=1, chunk=0)) for s in snaps.snapshots]
    out.append(("chunks", [astuple(c) for c in chunks], None, None))
    step("bad chunk", lambda: app.load_snapshot_chunk(abci.LoadSnapshotChunkRequest(
        height=99, format=1)))
    fresh = kv.KVStoreApp(db_mod.MemDB())
    step("apply unoffered", lambda: fresh.apply_snapshot_chunk(abci.ApplySnapshotChunkRequest(
        chunk=b"x")))
    step("offer bad format", lambda: fresh.offer_snapshot(abci.OfferSnapshotRequest(
        snapshot=abci.Snapshot(height=2, format=9))))
    last = snaps.snapshots[-1]
    step("offer", lambda: fresh.offer_snapshot(abci.OfferSnapshotRequest(snapshot=last)))
    step("apply tampered", lambda: fresh.apply_snapshot_chunk(abci.ApplySnapshotChunkRequest(
        chunk=chunks[-1].chunk + b" ")))
    step("offer again", lambda: fresh.offer_snapshot(abci.OfferSnapshotRequest(snapshot=last)))
    step("apply", lambda: fresh.apply_snapshot_chunk(abci.ApplySnapshotChunkRequest(
        chunk=chunks[-1].chunk)))
    out.append(("restored", astuple(fresh.info(abci.InfoRequest())), None, fresh.app_hash))
    reloaded = kv.KVStoreApp(db)
    out.append(("reloaded", astuple(reloaded.info(abci.InfoRequest())), None,
                reloaded.get("a")))
    return out


def test_kvstore_stream_equals_the_reference():
    want = _stream((rabci, rkv, rdb), ringest)
    got = _stream((pabci, pkv, pdb), pingest)
    assert [name for name, *_ in got] == [name for name, *_ in want]
    for w, p in zip(want, got):
        assert p == w, w[0]
    codes = {name: resp[0] for name, resp, *_ in want if name.startswith("check_tx")}
    assert sorted(set(codes.values())) == [0, 1, 2, 3]


def test_envelopes_equal_the_reference():
    key = ref_keys(rng(9301), 1)[0]
    tx = ringest.make_signed_tx(key, b"k=v")
    for t in (tx, b"k=v", b"stx:", b"stx:" + b"g" * 193 + b"p", tx[:60]):
        assert outcome(lambda: pingest.parse_signed_tx(t)) == \
            outcome(lambda: ringest.parse_signed_tx(t))
        if outcome(lambda: ringest.parse_signed_tx(t))[0] == "ok":
            assert pingest.parse_signed_tx(t) == ringest.parse_signed_tx(t)
        assert pingest.signed_tx_payload(t) == ringest.signed_tx_payload(t)
    assert pingest.sign_bytes(b"p") == ringest.sign_bytes(b"p")


# -- pub/sub -------------------------------------------------------------------

QUERIES = [
    "tm.event='NewBlock'", "tm.event = 'Tx' AND tx.height > 5",
    "tx.height >= 3 AND tx.height <= 7", "app.key EXISTS", "app.key CONTAINS 'k1'",
    "block.height = 5", "account.balance < -1.5", "a.b-c.d='x y'", "x.y = 5.0",
    "tm.event='Tx' AND app.key='k12' AND tx.height<10",
    "", "   ", "tm.event", "tm.event =", "= 'x'", "tx.height > 'abc'",
    "a = 1 OR b = 2", "a = 'x' b = 'y'", "a @ 1", "a = 'unterminated", "a CONTAINS 3",
    "AND a = 1", "a = 1 AND",
]

EVENTS = [
    {}, {"tm.event": ["NewBlock"], "block.height": ["5"]},
    {"tm.event": ["Tx"], "tx.height": ["6"], "app.key": ["k12", "k1x"]},
    {"tm.event": ["Tx"], "tx.height": ["3"], "app.key": ["other"]},
    {"account.balance": ["-2", "abc"], "a.b-c.d": ["x y"], "x.y": ["5"]},
    {"tx.height": ["7.0", "nan"]},
]


@pytest.mark.parametrize("q", QUERIES)
def test_query_parses_and_matches_as_the_reference(q):
    want = outcome(lambda: rpubsub.Query.parse(q))
    assert outcome(lambda: ppubsub.Query.parse(q)) == want
    if want == ("ok",):
        rq, pq = rpubsub.Query.parse(q), ppubsub.Query.parse(q)
        assert str(pq) == str(rq)
        assert [astuple(c) for c in pq.conditions] == [astuple(c) for c in rq.conditions]
        assert [pq.matches(e) for e in EVENTS] == [rq.matches(e) for e in EVENTS]


def test_server_delivers_and_drops_as_the_reference():
    def run(mod):
        dropped, log = [], []
        srv = mod.Server(capacity=2, on_drop=dropped.append)
        subs = {cid: srv.subscribe(cid, q) for cid, q in (
            ("a", "tm.event='Tx'"), ("b", mod.ALL), ("c", "tx.height > 5"))}
        log.append(outcome(lambda: srv.subscribe("a", "tm.event='Tx'")))
        for e in EVENTS:
            srv.publish(len(log), e)
        log.append(outcome(lambda: srv.unsubscribe("zz", "tm.event='Tx'")))
        log.append(outcome(lambda: srv.unsubscribe_all("zz")))
        for cid, sub in subs.items():
            got = []
            while (m := sub.try_next()) is not None:
                got.append(m.events)
            log.append((cid, got, sub.canceled, sub.cancel_reason))
        log.append((srv.num_clients(), srv.queue_depths(), dropped))
        srv.unsubscribe("a", "tm.event='Tx'")
        log.append((outcome(lambda: subs["a"].next(timeout=0.01)), srv.num_clients(),
                    srv.num_client_subscriptions("c")))
        return log

    assert run(ppubsub) == run(rpubsub)
