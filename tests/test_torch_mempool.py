"""The port's mempool (cometbft_tpu_torch/mempool: TxCache, CListMempool,
the pre/post checks, the mempool reactor and its codec) and the proposal
path of state/execution.py (``create_proposal_block``,
``process_proposal``, ``extended_commit_info``) against the reference's
(cometbft_tpu/...), which imports no jax for these modules.

The same inputs, made from a seed with numpy, go to both packages: one
scripted sequence of CheckTx calls (plain and signed txs, a forged and a
malformed envelope, duplicates, a full pool, too large a tx, pre- and
post-check refusals), reaps by bytes and by gas, updates with committed
txs and failed results, rechecks and a flush runs through a CListMempool
of each package over its KVStoreApp; a proposal block is built by each
package's executor from the same state, txs and time, at the initial
height and after a block with a signed LastCommit.  Tolerance: exact --
sizes, byte counts, order, responses, errors (class and message), block
bytes and hashes, and the ``MempoolMetrics`` exposition.  The port runs
on ``device="cpu"``; the reference verifies with
CMT_TPU_DISABLE_DEVICE_VERIFY=1.  Every wait is bounded."""

import threading
import time
from dataclasses import replace

import pytest

from cometbft_tpu import metrics as rmetrics
from cometbft_tpu import proxy as rproxy
from cometbft_tpu import state as rstate
from cometbft_tpu.abci import kvstore as rkv
from cometbft_tpu.abci import types as rtypes
from cometbft_tpu.crypto import ed25519 as red
from cometbft_tpu.mempool import ingest as ringest
from cometbft_tpu.mempool import reactor as rmreactor
from cometbft_tpu.state import execution as rexec
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types import genesis as rgenesis
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import log as rlog
from cometbft_tpu.utils import metrics as rumetrics
import cometbft_tpu.mempool as rmempool
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch import proxy as pproxy
from cometbft_tpu_torch import state as pstate
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import types as ptypes
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.crypto import verify_queue as vq
from cometbft_tpu_torch.crypto.batch import create_batch_verifier
from cometbft_tpu_torch.mempool import ingest as pingest
from cometbft_tpu_torch.mempool import reactor as pmreactor
from cometbft_tpu_torch.p2p import test_util as ptest_util
from cometbft_tpu_torch.state import execution as pexec
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.types import genesis as pgenesis
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import log as plog
from cometbft_tpu_torch.utils import metrics as pumetrics
import cometbft_tpu_torch.mempool as pmempool
from cometbft_tpu.p2p import test_util as rtest_util
from tests.test_torch_types import outcome, rng
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

CHAIN = "mempool-parity"
T0 = 1_700_000_000_000_000_000

REF = dict(mempool=rmempool, kv=rkv, proxy=rproxy, db=rdb, types=rtypes, ingest=ringest,
           metrics=rmetrics, registry=rumetrics.Registry, ed=red, kw={})
PORT = dict(mempool=pmempool, kv=pkv, proxy=pproxy, db=pdb, types=ptypes, ingest=pingest,
            metrics=pmetrics, registry=pumetrics.Registry, ed=ped, kw=dict(device="cpu"))


# -- TxCache ------------------------------------------------------------------------

@pytest.mark.parametrize("size,shards", [(1, None), (2, None), (5, 1), (16, 8), (7, 3)])
def test_tx_cache_follows_the_reference(size, shards):
    g = rng(100 + size)
    txs = [g.bytes(int(g.integers(1, 40))) for _ in range(12)]
    ops = [(str(g.choice(["push", "has", "remove"])), txs[int(g.integers(0, 12))])
           for _ in range(200)]

    def run(mod):
        c = mod.TxCache(size, shards)
        out = [getattr(c, op)(tx) for op, tx in ops]
        out.append(len(c))
        c.reset()
        return out + [len(c)]

    assert run(pmempool) == run(rmempool)
    nop = pmempool.NopTxCache()
    assert nop.push(b"x") and nop.push(b"x") and not nop.has(b"x")
    assert pmempool.TXCACHE_SHARDS == rmempool.DEFAULT_TXCACHE_SHARDS


def test_pre_and_post_checks_equal_the_reference():
    for n in (0, 5, 100):
        for tx in (b"", b"abcde", b"x" * 101):
            assert outcome(lambda: pmempool.pre_check_max_bytes(n)(tx)) == \
                outcome(lambda: rmempool.pre_check_max_bytes(n)(tx))
    for gas in (-1, 0, 5):
        for wanted in (0, 5, 6):
            assert outcome(lambda: pmempool.post_check_max_gas(gas)(
                b"t", ptypes.CheckTxResponse(gas_wanted=wanted))) == outcome(
                lambda: rmempool.post_check_max_gas(gas)(
                    b"t", rtypes.CheckTxResponse(gas_wanted=wanted)))


# -- CListMempool over a scripted sequence --------------------------------------------

def _signed(side, secret: bytes, payload: bytes) -> bytes:
    return side["ingest"].make_signed_tx(side["ed"].priv_key_from_secret(secret), payload)


def _script_txs(g) -> dict:
    """The txs of the script, in the reference's encodings."""
    plain = [b"k%d=%s" % (i, g.bytes(8).hex().encode()) for i in range(6)]
    signed = [_signed(REF, b"sender-%d" % i, b"s%d=%s" % (i, g.bytes(6).hex().encode()))
              for i in range(4)]
    forged = bytearray(signed[0])
    forged[-1] ^= 1
    bad_sig = _signed(REF, b"sender-9", b"forged=1")
    bad_sig = bad_sig[:20] + (b"0" if bad_sig[20:21] != b"0" else b"1") + bad_sig[21:]
    return dict(plain=plain, signed=signed, forged=bytes(forged), bad_sig=bad_sig,
                malformed=b"stx:zz" + b"0" * 200 + b":p=q", not_kv=b"no-equals-sign",
                big=b"big=" + b"x" * 500)


def _state(mp, side) -> tuple:
    return (mp.size(), mp.size_bytes(), mp.reap_max_txs(-1), mp.reap_max_txs(2),
            mp.reap_max_bytes_max_gas(-1, -1), mp.reap_max_bytes_max_gas(60, -1),
            mp.reap_max_bytes_max_gas(-1, 2), mp.current_seq(), mp.txs_after(0, "peer-a"),
            mp.txs_after(2), mp.txs_available().is_set())


def _res(r) -> tuple:
    return (r.code, r.gas_wanted, r.log) if r is not None else None


def _mempool_script(side, t: dict) -> list:
    M, T = side["mempool"], side["types"]
    app = side["kv"].KVStoreApp(side["db"].MemDB())
    conns = side["proxy"].new_app_conns(side["proxy"].local_client_creator(app))
    reg = side["registry"]()
    mp = M.CListMempool(conns.mempool, height=0, size=8, max_tx_bytes=400, cache_size=6,
                        metrics=side["metrics"].MempoolMetrics(reg), **side["kw"])
    out = []

    def check(tx, sender=""):
        got = []
        res = outcome(lambda: got.append(mp.check_tx(tx, sender=sender)))
        out.append(("check", res, _res(got[0]) if got else None, _state(mp, side)))

    for tx in t["plain"][:3]:
        check(tx)
    check(t["plain"][0])                       # a duplicate
    check(t["plain"][1], "peer-a")             # a duplicate from a peer
    for tx in t["signed"][:2]:
        check(tx, "peer-b")
    check(t["forged"])                         # the payload changed under the signature
    check(t["bad_sig"])
    check(t["malformed"])
    check(t["not_kv"])                         # the app refuses it
    check(t["big"])                            # over max_tx_bytes
    mp.pre_check = M.pre_check_max_bytes(40)
    check(t["plain"][3] + b"-long-enough-to-fail-the-pre-check")
    mp.pre_check = None
    mp.post_check = M.post_check_max_gas(0)
    check(t["plain"][4])                       # gas 1 > 0
    mp.post_check = None
    for tx in t["plain"][3:] + t["signed"][2:]:
        check(tx)                              # fills the pool of 8
    check(_signed(side, b"late", b"late=1"))   # full
    # a block commits three txs, one of them with a failed result
    committed = [t["plain"][0], t["signed"][0], t["plain"][2]]
    results = [T.ExecTxResult(code=0), T.ExecTxResult(code=0), T.ExecTxResult(code=5)]
    mp.lock()
    try:
        mp.update(1, committed, results, M.pre_check_max_bytes(400), M.post_check_max_gas(10))
    finally:
        mp.unlock()
    out.append(("update", _state(mp, side)))
    check(t["plain"][0])                       # committed: still in the cache
    check(t["plain"][2])                       # failed: out of the cache, admitted again
    app.finalize_block(T.FinalizeBlockRequest(txs=(t["plain"][1],), height=1))
    mp.lock()
    try:
        mp.update(2, [], [])                   # a recheck pass
    finally:
        mp.unlock()
    out.append(("recheck", _state(mp, side)))
    mp.flush()
    out.append(("flush", _state(mp, side)))
    out.append(reg.expose())
    return out


def test_clist_mempool_follows_the_reference():
    t = _script_txs(rng(110))
    ref = _mempool_script(REF, t)
    port = _mempool_script(PORT, t)
    assert port[:-1] == ref[:-1]
    # the port checked its signed txs inline on the host tier, as the
    # reference did with no queue: the exposition is the same too, but
    # for the admission wall's buckets and sum (a timing: OpenSSL in the
    # reference, the host tier in the port)
    def untimed(expo):
        return [x for x in expo.splitlines() if not x.startswith(
            ("cometbft_mempool_checktx_sig_seconds_bucket",
             "cometbft_mempool_checktx_sig_seconds_sum"))]

    assert untimed(port[-1]) == untimed(ref[-1])
    assert "cometbft_mempool_checktx_sig_seconds_count 4" in port[-1]
    kinds = {r[1][0] for r in ref if r[0] == "check"}
    assert {"ok", "TxInCacheError", "TxSignatureError", "TxTooLargeError",
            "MempoolFullError", "MempoolError"} <= kinds


def test_signed_txs_ride_the_ingest_lane():
    """With a queue installed, concurrent CheckTx calls coalesce on the
    ingest lane and count as batched; a forged one is refused."""
    reg = pumetrics.Registry()
    conns = pproxy.new_app_conns(pproxy.local_client_creator(pkv.KVStoreApp()))
    mp = pmempool.CListMempool(conns.mempool, metrics=pmetrics.MempoolMetrics(reg), device="cpu")
    txs = [_signed(PORT, b"lane-%d" % i, b"lane%d=v" % i) for i in range(16)]
    forged = txs[3][:-1] + bytes([txs[3][-1] ^ 1])
    q = vq.VerifyQueue(verifier_factory=lambda pk: create_batch_verifier(pk, device="cpu"))
    q.start()
    vq.install_queue(q)
    errors: list = []
    try:
        def send(chunk):
            for tx in chunk:
                try:
                    mp.check_tx(tx)
                except Exception as exc:  # noqa: BLE001 -- compared below
                    errors.append(type(exc).__name__)

        ts = [threading.Thread(target=send, args=(txs[k::4] + ([forged] if k == 0 else []),))
              for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        stats = q.stats()
    finally:
        q.stop()
    assert errors == ["TxSignatureError"] and mp.size() == 16
    assert stats["submitted"]["ingest"] == 17 and stats["failed_batches"] == 0
    expo = reg.expose()
    assert "cometbft_mempool_checktx_batched 17" in expo


# -- the mempool reactor ----------------------------------------------------------------

def test_txs_codec_equals_the_reference():
    g = rng(120)
    for n in (0, 1, 5):
        txs = [g.bytes(int(g.integers(0, 70))) for _ in range(n)]
        raw = rmreactor.encode_txs(txs)
        assert pmreactor.encode_txs(txs) == raw
        assert pmreactor.decode_txs(raw) == rmreactor.decode_txs(raw) == txs
    for raw in (b"\x0a", b"\x0a\x05ab", b"\x08\x01", b"\xff"):
        assert outcome(lambda: pmreactor.decode_txs(raw)) == \
            outcome(lambda: rmreactor.decode_txs(raw))
    assert pmreactor.MEMPOOL_CHANNEL == rmreactor.MEMPOOL_CHANNEL
    d, rd = pmreactor.MempoolReactor(None).get_channels()[0], \
        rmreactor.MempoolReactor(None).get_channels()[0]
    assert (d.id, d.priority, d.send_queue_capacity, d.recv_message_capacity) == \
        (rd.id, rd.priority, rd.send_queue_capacity, rd.recv_message_capacity)


def test_txs_gossip_between_port_and_reference_mempools():
    """A port and a reference node over TCP: each one's txs reach the
    other's mempool through its reactor, and none comes back."""
    pconns = pproxy.new_app_conns(pproxy.local_client_creator(pkv.KVStoreApp()))
    rconns = rproxy.new_app_conns(rproxy.local_client_creator(rkv.KVStoreApp()))
    pmp = pmempool.CListMempool(pconns.mempool, device="cpu")
    rmp = rmempool.CListMempool(rconns.mempool)
    pr = pmreactor.MempoolReactor(pmp, logger=plog.NopLogger())
    rr = rmreactor.MempoolReactor(rmp, logger=rlog.NopLogger())
    a = ptest_util.make_switch(network=CHAIN, reactors={"MEMPOOL": pr})
    b = rtest_util.make_switch(network=CHAIN, reactors={"MEMPOOL": rr})
    ptx = [b"port%d=v" % i for i in range(5)] + [_signed(PORT, b"ps", b"psig=1")]
    rtx = [b"ref%d=v" % i for i in range(5)]
    try:
        a.start()
        b.start()
        # each side admits its own txs before the two connect, so no
        # gossiped tx can reach a mempool ahead of that mempool's own
        for tx in ptx:
            pmp.check_tx(tx)
        for tx in rtx:
            rmp.check_tx(tx)
        a.dial_peer_with_address(b.transport.listen_addr)
        deadline = time.monotonic() + 60
        while pmp.size() < 11 or rmp.size() < 11:
            assert time.monotonic() < deadline, (pmp.size(), rmp.size())
            time.sleep(0.01)
        time.sleep(0.3)
    finally:
        for sw in (a, b):
            if sw.is_running():
                sw.stop()
    assert sorted(pmp.reap_max_txs(-1)) == sorted(rmp.reap_max_txs(-1)) == sorted(ptx + rtx)
    assert pmp.reap_max_txs(-1)[:6] == ptx and rmp.reap_max_txs(-1)[:5] == rtx


# -- the proposal path -----------------------------------------------------------------

def _exec_side(side_mods, gen_json: str, txs, byz=None):
    """-> (an executor over a fresh genesis state with ``txs`` in its
    mempool, that state); ``byz`` is the port executor's adversary."""
    gen_mod, state_mod, kv, proxy, db, exe, mp_mod, T, kw = side_mods
    gen = gen_mod.GenesisDoc.from_json(gen_json)
    states = state_mod.Store(db.MemDB())
    state = state_mod.State.from_genesis(gen)
    states.save(state)
    app = kv.KVStoreApp(db.MemDB())
    app.init_chain(T.InitChainRequest(chain_id=gen.chain_id, validators=tuple(
        T.ValidatorUpdate("ed25519", v.pub_key.bytes(), v.power) for v in gen.validators)))
    conns = proxy.new_app_conns(proxy.local_client_creator(app))
    mp = mp_mod.CListMempool(conns.mempool, **kw)
    for tx in txs:
        mp.check_tx(tx)
    ex = exe.BlockExecutor(states, conns.consensus, mp, **kw,
                           **({} if byz is None else dict(byz=byz)))
    return ex, state


def test_create_proposal_block_equals_the_reference():
    """The same state, txs and time: block 1 at the genesis time, then
    block 2 over a signed LastCommit at its median time; the same bytes,
    the same hash; process_proposal accepts both and refuses a forged
    envelope alike."""
    from tests.test_torch_types import ref_commit

    g = rng(130)
    keys = [red.priv_key_from_secret(g.bytes(32)) for _ in range(4)]
    gen_json = rgenesis.GenesisDoc(chain_id=CHAIN, genesis_time_ns=T0, validators=tuple(
        rgenesis.GenesisValidator(k.pub_key(), 10) for k in keys)).to_json()
    t = _script_txs(g)
    txs = t["plain"] + t["signed"]
    ref_ex, rst = _exec_side((rgenesis, rstate, rkv, rproxy, rdb, rexec, rmempool, rtypes, {}),
                             gen_json, txs)
    port_ex, pst = _exec_side((pgenesis, pstate, pkv, pproxy, pdb, pexec, pmempool, ptypes,
                               dict(device="cpu")), gen_json, txs)
    proposer = rst.validators.get_proposer().address
    rb = ref_ex.create_proposal_block(1, rst, None, proposer)
    pb = port_ex.create_proposal_block(1, pst, None, proposer)
    assert pcodec.encode_block(pb) == rcodec.encode_block(rb) and pb.hash() == rb.hash()
    assert list(rb.data.txs) == txs
    # apply block 1 in both, then propose block 2 over its commit
    parts = rb.make_part_set(65536)
    bid = rblock.BlockID(rb.hash(), parts.header)
    rst2 = ref_ex.apply_block(rst, bid, rb)
    pst2 = port_ex.apply_block(pst, pcodec.decode_block_id(bid.encode()), pb)
    assert pstate.encode_state(pst2) == rstate.encode_state(rst2)
    commit = ref_commit(keys, bid, 1, g, signers=[0, 1, 3], chain_id=CHAIN, base_ns=T0 + 10**9)
    pcommit = pcodec.decode_commit(rcodec.encode_commit(commit))
    proposer2 = rst2.validators.get_proposer().address
    rb2 = ref_ex.create_proposal_block(2, rst2, commit, proposer2)
    pb2 = port_ex.create_proposal_block(2, pst2, pcommit, proposer2)
    assert pcodec.encode_block(pb2) == rcodec.encode_block(rb2) and pb2.hash() == rb2.hash()
    assert port_ex.process_proposal(pb2, pst2) is ref_ex.process_proposal(rb2, rst2) is True
    forged = replace(rb2, data=replace(rb2.data, txs=(t["forged"],))).with_hashes()
    pforged = pcodec.decode_block(rcodec.encode_block(forged))
    assert port_ex.process_proposal(pforged, pst2) is \
        ref_ex.process_proposal(forged, rst2) is False


def test_extended_commit_info_equals_the_reference():
    from tests.test_torch_types import ref_val_set

    g = rng(140)
    keys = [red.priv_key_from_secret(g.bytes(32)) for _ in range(5)]
    vals, keys = ref_val_set(keys)
    from tests.test_torch_types import port_val_set

    pvals = port_val_set(vals)
    bid = rblock.BlockID(g.bytes(32), rblock.PartSetHeader(1, g.bytes(32)))
    other = rblock.BlockID(g.bytes(32), rblock.PartSetHeader(1, g.bytes(32)))
    from tests.test_torch_types import ref_commit, signed_precommit

    commit = ref_commit(keys, bid, 3, g, signers=[0, 1, 2, 4], chain_id=CHAIN)
    votes = []
    for i, k in enumerate(keys):
        if i == 3:
            votes.append(None)
            continue
        target = other if i == 4 else (rblock.BlockID() if i == 2 else bid)
        v = signed_precommit(k, i, target, 3, 0, T0 + i, chain_id=CHAIN)
        votes.append(replace(v, extension=b"ext-%d" % i, extension_signature=g.bytes(64)))
    from cometbft_tpu_torch.types import vote as pvote

    pvotes = [None if v is None else pvote.Vote.decode(v.encode()) for v in votes]
    pcommit = pcodec.decode_commit(rcodec.encode_commit(commit))
    r = rexec.extended_commit_info(commit, votes, vals)
    p = pexec.extended_commit_info(pcommit, pvotes, pvals)
    assert p.round == r.round
    assert [vars(x) for x in p.votes] == [vars(x) for x in r.votes]
    assert [x.block_id_flag for x in p.votes] == [2, 2, 3, 1, 1]


# -- metrics ------------------------------------------------------------------------------

def _drive_mempool_metrics(m) -> None:
    m.size.set(7)
    m.size_bytes.set(700)
    m.tx_size_bytes.observe(100)
    m.failed_txs.inc()
    m.evicted_txs.inc(2)
    m.recheck_times.inc()
    for r in ("accepted", "duplicate", "full", "sig", "app", "precheck", "too_large"):
        m.checktx_total.labels(result=r).inc()
    m.checktx_sig_seconds.observe(0.003)
    m.checktx_batched.inc(5)
    m.checktx_inline.inc()


def test_mempool_metrics_exposition_equals_the_reference():
    rreg, preg = rumetrics.Registry(), pumetrics.Registry()
    _drive_mempool_metrics(rmetrics.MempoolMetrics(rreg))
    _drive_mempool_metrics(pmetrics.MempoolMetrics(preg))
    assert preg.expose() == rreg.expose()
    _drive_mempool_metrics(pmetrics.MempoolMetrics())
