"""The port's blocksync (cometbft_tpu_torch/blocksync: the pool, the
reactor and its five wire messages) against the reference's
(cometbft_tpu/blocksync), which imports no jax.

The messages go both ways between the packages' codecs, a malformed one
refused alike.  The pool runs the reference's own
``tests/test_blocksync.py::TestBlockPool`` cases and more, both pools with
one seeded ``random.Random`` and one patched clock.  A whole sync runs in
each package between three nodes, each a switch of its package's
``p2p/test_util.make_switch`` over 127.0.0.1 TCP (secret connections,
MConnection): a fresh node syncs tests/test_torch_execution.py's chain
from a byzantine peer, whose block ``BAD`` carries a flipped LastCommit
signature, then from an honest one, dialled when the byzantine one is
removed; one more sync runs the port's node against the reference's
servers.  Tolerance: exact -- the synced block and state DBs key for
key, the app's record, the state handed to consensus in
``encode_state`` bytes, the stops and the ``BlockSyncMetrics``
exposition, each the reference's and the source's.
The reference verifies with CMT_TPU_DISABLE_DEVICE_VERIFY=1, the port on
``device="cpu"``; one case sends the prefetch batches (8 x 9 = 72
signatures, over the threshold of 64) through the keyed tier's plain
path.  Where the port departs on purpose -- a fault that is not a
verification error never reads as a peer's bad block -- the test says
so.  Every wait is bounded."""

import random
import threading
from dataclasses import replace

import pytest
import torch

from cometbft_tpu import metrics as rmetrics
from cometbft_tpu import state as rstate
from cometbft_tpu import store as rstore
from cometbft_tpu.blocksync import pool as rpool
from cometbft_tpu.blocksync import reactor as rreactor
from cometbft_tpu.crypto import verify_queue as jvq
from cometbft_tpu.p2p import test_util as rtest_util
from cometbft_tpu.p2p.conn import connection as rconn
from cometbft_tpu.p2p.conn import secret_connection as rsc
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types.block_meta import BlockMeta as RBlockMeta
from cometbft_tpu.types.part_set import BLOCK_PART_SIZE_BYTES
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import log as rlog
from cometbft_tpu.utils import metrics as rumetrics
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch import state as pstate
from cometbft_tpu_torch import store as pstore
from cometbft_tpu_torch.blocksync import pool as ppool
from cometbft_tpu_torch.blocksync import reactor as preactor
from cometbft_tpu_torch.crypto import batch as B
from cometbft_tpu_torch.crypto import verify_queue as vq
from cometbft_tpu_torch.ops.ed25519_verify import TorchBatchVerifier
from cometbft_tpu_torch.p2p import test_util as ptest_util
from cometbft_tpu_torch.p2p.conn import connection as pconn
from cometbft_tpu_torch.p2p.conn import secret_connection as psc
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import log as plog
from cometbft_tpu_torch.utils import metrics as pumetrics
from cometbft_tpu_torch.utils.flight import FLIGHT
from tests.test_torch_execution import HEIGHTS, exec_chain, image, port_node, ref_node
from tests.test_torch_types import outcome, ref_keys, rng, signed_precommit
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

BAD = 10            # the byzantine peer's block with a flipped LastCommit signature
WAIT = 60.0

REF = dict(reactor=rreactor, pool=rpool, db=rdb, blocks=rstore.BlockStore, states=rstate.Store,
           state=rstate, node=ref_node, metrics=rmetrics, registry=rumetrics.Registry,
           vq=jvq, log=rlog, util=rtest_util, kw={},
           wire_errors=(rsc.SecretConnectionError, rconn.MConnError, OSError))
PORT = dict(reactor=preactor, pool=ppool, db=pdb, blocks=pstore.BlockStore,
            states=pstate.Store, state=pstate, node=port_node, metrics=pmetrics,
            registry=pumetrics.Registry, vq=vq, log=plog, util=ptest_util, kw=dict(device="cpu"),
            wire_errors=(psc.SecretConnectionError, pconn.MConnError, OSError))


# -- the wire messages ---------------------------------------------------------

def _messages(side):
    """The five messages in ``side``'s encoders, a block response with
    and without its extended-votes blob."""
    _, recs, _ = exec_chain()
    R = side["reactor"]
    block = recs[4]["block"]
    if side is PORT:
        block = pcodec.decode_block(rcodec.encode_block(block))
    key = ref_keys(rng(9400), 1)[0]
    votes = [signed_precommit(key, 0, recs[4]["bid"], 5, 0, 7), None]
    blob = rstore.BlockStore._encode_extended_votes(votes)
    return [R.encode_block_request(5), R.encode_block_request(1 << 40),
            R.encode_no_block_response(7), R.encode_block_response(block),
            R.encode_block_response(block, blob), R.encode_status_request(),
            R.encode_status_response(25, 1), R.encode_status_response(0, 0)]


def _decoded(msg) -> tuple:
    """A decoded message, its block and votes by their bytes."""
    out = []
    for x in msg:
        if hasattr(x, "header"):
            x = rcodec.encode_block(x) if type(x).__module__.startswith("cometbft_tpu.") \
                else pcodec.encode_block(x)
        elif isinstance(x, list):
            x = [None if v is None else v.encode() for v in x]
        out.append(x)
    return tuple(out)


def test_messages_equal_the_reference_both_ways():
    ref, port = _messages(REF), _messages(PORT)
    assert port == ref
    for raw in ref:
        assert _decoded(preactor.decode_bs_message(raw)) == \
            _decoded(rreactor.decode_bs_message(raw))


MALFORMED = [b"", b"\x0a", b"\x0a\x02\x08", b"\x2a\x02\x08\xff", b"\x1a\x03\x0a\x01\x00",
             b"\x32\x00", b"\x08\x01", b"\x1a\x00", b"\xff\xff\xff"]


@pytest.mark.parametrize("raw", MALFORMED)
def test_malformed_messages_are_refused_alike(raw):
    assert outcome(lambda: preactor.decode_bs_message(raw)) == \
        outcome(lambda: rreactor.decode_bs_message(raw))


# -- the pool ------------------------------------------------------------------

class Clock:
    def __init__(self) -> None:
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


class FakeBlock:
    def __init__(self, height: int) -> None:
        self.header = type("H", (), {"height": height})()


def _pool_case(side, case: str, monkeypatch):
    """One scripted pool case -> what it sent, errored and answered."""
    clock = Clock()
    monkeypatch.setattr(side["pool"], "time", clock)
    sent, errors, log = [], [], []
    pool = side["pool"].BlockPool(1, lambda p, h: sent.append((p, h)),
                                  lambda p, r: errors.append((p, r)))
    pool._rng = random.Random(7)
    if case == "requests_fill_window_and_complete":
        pool.set_peer_range("peerA", 1, 5)
        pool.set_peer_range("peerB", 1, 5)
        pool.make_next_requests()
        log.append(sorted(h for _, h in sent))
    elif case == "add_block_requires_matching_peer":
        pool.set_peer_range("peerA", 1, 3)
        pool.make_next_requests()
        log.append(pool.add_block("stranger", FakeBlock(1), 100))
        log.append(pool.add_block("peerA", FakeBlock(1), 100))
        log.append(pool.add_block("peerA", FakeBlock(1), 100))
    elif case == "timeout_reassigns":
        monkeypatch.setattr(side["pool"], "REQUEST_TIMEOUT", 0.01)
        pool.set_peer_range("slow", 1, 2)
        pool.make_next_requests()
        clock.t += 0.05
        pool.set_peer_range("fast", 1, 2)
        pool.make_next_requests()
    elif case == "caught_up":
        pool = side["pool"].BlockPool(5, lambda p, h: None, lambda p, r: None)
        log.append(pool.is_caught_up())
        pool.set_peer_range("a", 1, 4)
        log.append(pool.is_caught_up())
        pool.set_peer_range("b", 1, 9)
        log.append(pool.is_caught_up())
    elif case == "many_peers_and_a_redo":
        for i in range(5):
            pool.set_peer_range(f"p{i}", 1 + i, 60 + 7 * i)
        for _ in range(3):
            pool.make_next_requests()
        owners = {h: p for p, h in sent}
        for h in (1, 2, 3, 5):
            log.append(pool.add_block(owners[h], FakeBlock(h), 10 * h))
        log.append([b is not None for b in pool.peek_blocks_from(1, 6)])
        log.append([b is not None for b in pool.peek_two_blocks()])
        pool.pop_request()
        log.append(pool.redo_request(2))
        pool.no_block(owners[4], 4)
        pool.remove_peer("p4")
        clock.t += 1.0
        pool.make_next_requests()
        log.append((pool.status(), pool.max_peer_height(), pool.num_peers()))
    return sent, errors, log


POOL_CASES = ("requests_fill_window_and_complete", "add_block_requires_matching_peer",
              "timeout_reassigns", "caught_up", "many_peers_and_a_redo")


@pytest.mark.parametrize("case", POOL_CASES)
def test_pool_equals_the_reference(case, monkeypatch):
    want = _pool_case(REF, case, monkeypatch)
    got = _pool_case(PORT, case, monkeypatch)
    assert got == want
    if case == "timeout_reassigns":
        assert [p for p, _ in got[1]] == ["slow"] and any(p == "fast" for p, _ in got[0])


def test_pool_takes_its_rng():
    rng_ = random.Random(3)
    pool = ppool.BlockPool(1, lambda p, h: None, lambda p, r: None, rng=rng_)
    assert pool._rng is rng_


# -- a whole sync between nodes over TCP ----------------------------------------

class ConsensusRecorder:
    """Stands in for the consensus reactor: keeps the state blocksync
    hands over."""

    def __init__(self) -> None:
        self.states: list = []
        self.done = threading.Event()

    def switch_to_consensus(self, state) -> None:
        self.states.append(state)
        self.done.set()


def _bad_block_entries():
    """The byzantine peer's block BAD: LastCommit signature #0 flipped,
    its parts and meta rewritten (the header unchanged)."""
    _, recs, _ = exec_chain()
    block = recs[BAD - 1]["block"]
    lc = block.last_commit
    cs = lc.signatures[0]
    sig = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    bad = replace(block, last_commit=replace(
        lc, signatures=(replace(cs, signature=sig),) + lc.signatures[1:]))
    parts = bad.make_part_set(BLOCK_PART_SIZE_BYTES)
    out = {rstore._pkey(BAD, i): rcodec.encode_part(parts.get_part(i))
           for i in range(parts.header.total)}
    out[rstore._hkey(rstore._META, BAD)] = RBlockMeta.from_parts(bad, parts).encode()
    return out


def _server(side, byzantine: bool):
    _, _, src = exec_chain()
    bdb, sdb = side["db"].MemDB(), side["db"].MemDB()
    blocks = image(src["bdb"])
    if byzantine:
        blocks.update(_bad_block_entries())
    for db, img in ((bdb, blocks), (sdb, image(src["sdb"]))):
        for k, v in img.items():
            db.set(k, v)
    bstore, sstore = side["blocks"](bdb), side["states"](sdb)
    return side["reactor"].BlocksyncReactor(sstore.load(), None, bstore, False,
                                           logger=side["log"].NopLogger(), **side["kw"])


def _record_stops(sw, names: dict, stops: list) -> None:
    """Records every stop of a peer still in ``sw``'s set as (its name,
    the reason)."""
    real = sw.stop_peer_for_error

    def stop_peer_for_error(peer, reason) -> None:
        if sw.peers.has(peer.id):
            stops.append((names.get(peer.id, peer.id), reason))
        real(peer, reason)

    sw.stop_peer_for_error = stop_peer_for_error


def run_sync(side, monkeypatch, byzantine: bool = True, factory=None, hold: int = 0,
             servers=None) -> dict:
    """A fresh node of ``side`` syncs the chain from nodes of ``servers``
    (default ``side``) over TCP (the byzantine peer first when
    ``byzantine``, the honest one dialled when it is removed) -> what it
    stored, handed over and stopped.  ``hold``: the first sync step
    waits until blocks 1..hold have arrived, so its prefetch takes a full
    window."""
    servers = servers or side
    gen, _, _ = exec_chain()
    R = side["reactor"]
    monkeypatch.setattr(R, "SWITCH_TO_CONSENSUS_INTERVAL", 0.05)
    node = side["node"](gen) if side is PORT else side["node"](gen, validate=True)
    registry = side["registry"]()
    recorder = ConsensusRecorder()
    reactor = R.BlocksyncReactor(node["state"], node["exec"], node["blocks"], True,
                                 consensus_reactor=recorder, logger=side["log"].NopLogger(),
                                 metrics=side["metrics"].BlockSyncMetrics(registry),
                                 **side["kw"])
    syncer = side["util"].make_switch(moniker="syncer", reactors={"BLOCKSYNC": reactor})
    byz = servers["util"].make_switch(moniker="byzantine",
                                      reactors={"BLOCKSYNC": _server(servers, True)})
    honest = servers["util"].make_switch(moniker="honest",
                                         reactors={"BLOCKSYNC": _server(servers, False)})
    switches = [syncer, byz, honest]
    names = {sw.node_info().node_id: sw.node_info().moniker for sw in switches}
    stops, server_stops, redone = [], [], []
    _record_stops(syncer, names, stops)
    for sw in (byz, honest):
        _record_stops(sw, names, server_stops)
    redo = reactor.pool.redo_request

    def redo_request(height):
        pid = redo(height)
        redone.append((height, names.get(pid, pid)))
        return pid

    reactor.pool.redo_request = redo_request
    step = reactor._try_sync_step

    def held_step():
        if hold and reactor.pool.height == 1 and None in reactor.pool.peek_blocks_from(1, hold):
            return False
        return step()

    reactor._try_sync_step = held_step
    remove = reactor.remove_peer

    def remove_peer(peer, reason=None):
        remove(peer, reason)
        if names.get(peer.id) == "byzantine" and not syncer.peers.has(
                honest.node_info().node_id):
            syncer.dial_peers_async([honest.transport.listen_addr])

    reactor.remove_peer = remove_peer
    q = side["vq"].VerifyQueue(verifier_factory=factory)
    q.start()
    side["vq"].install_queue(q)
    try:
        for sw in switches:
            sw.start()
        syncer.dial_peer_with_address((byz if byzantine else honest).transport.listen_addr)
        assert recorder.done.wait(WAIT), "no switch to consensus"
        stops, server_stops = list(stops), list(server_stops)
    finally:
        for sw in switches:
            if sw.is_running():
                sw.stop()
        thread = getattr(reactor, "_pool_thread", None)
        if thread is not None:
            thread.join(WAIT)
        q.stop()
        side["vq"].install_queue(None)
    return dict(block_image=image(node["bdb"]), state_image=image(node["sdb"]),
                app=node["adb"].get(b"kvstore:state"), app_hash=node["app"].app_hash,
                state=side["state"].encode_state(recorder.states[-1]),
                stops=[(n, str(r)) for n, r in stops],
                server_stops=[(n, isinstance(r, servers["wire_errors"])) for n, r in server_stops],
                redone=redone, exposition=registry.expose(),
                errors=getattr(reactor, "pool_routine_errors", 0))


def _source() -> dict:
    _, recs, src = exec_chain()
    top = recs[HEIGHTS - 1]
    return dict(block_image=top["block_image"], state_image=top["state_image"],
                app=top["app_record"], app_hash=src["app"].app_hash,
                state=rstate.encode_state(top["after"]))


def _check_against_source(got: dict) -> None:
    want = _source()
    for k, v in want.items():
        assert got[k] == v, k
    assert got["stops"] == [("byzantine", "sent invalid block")]
    # a server stops the syncer only when the syncer closed the connection
    assert all(stop == ("syncer", True) for stop in got["server_stops"]), got["server_stops"]
    assert got["errors"] == 0
    assert got["redone"] == [(BAD - 1, "byzantine"), (BAD, "")]


def test_sync_equals_the_reference(monkeypatch):
    want = run_sync(REF, monkeypatch)
    got = run_sync(PORT, monkeypatch, factory=lambda pk: B.create_batch_verifier(
        pk, device="cpu"))
    _check_against_source(want)
    _check_against_source(got)
    assert got["exposition"] == want["exposition"]
    assert "cometbft_blocksync_peer_evictions 1" in got["exposition"]


def test_port_node_syncs_from_reference_servers(monkeypatch):
    """The port's syncer (device="cpu") dials the reference's byzantine
    and honest servers over TCP: the handshakes and packets of both
    packages interoperate, and it stores the source's blocks and states
    key for key."""
    got = run_sync(PORT, monkeypatch, servers=REF,
                   factory=lambda pk: B.create_batch_verifier(pk, device="cpu"))
    _check_against_source(got)


def test_sync_prefetches_through_the_keyed_plain_path(monkeypatch):
    """The queue's prefetch batches of 8 commits (72 signatures) cross the
    device threshold of 64 and take the keyed tier's plain path on the
    CPU; the sync ends as the reference's does."""
    made = []

    def factory(pk):
        bv = TorchBatchVerifier(device="cpu", device_min_batch=64)
        made.append(bv)
        return bv

    got = run_sync(PORT, monkeypatch, factory=factory, hold=10)
    _check_against_source(got)
    keyed = [len(bv) for bv in made if bv.last_tier == "keyed"]
    assert keyed and all(n >= 64 for n in keyed)
    assert {bv.last_tier for bv in made if len(bv)} <= {"keyed", "host"}


def test_device_fault_is_not_a_bad_block(monkeypatch):
    """A fault of the card (here: the first commit check raises
    RuntimeError) reaches the pool routine, which logs it, counts it,
    records it in FLIGHT and retries: no peer is stopped, no height
    redone.  The reference reads any exception there as the peers'
    fault and stops them (blocksync/reactor.py:348).  Every check gets
    the reactor's device."""
    real, calls = preactor.verify_commit_light, []

    def flaky(*args, **kwargs):
        calls.append(kwargs.get("device"))
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(*args, **kwargs)

    monkeypatch.setattr(preactor, "verify_commit_light", flaky)
    FLIGHT.clear()
    got = run_sync(PORT, monkeypatch, byzantine=False,
                   factory=lambda pk: B.create_batch_verifier(pk, device="cpu"))
    for k, v in _source().items():
        assert got[k] == v, k
    assert got["stops"] == [] and got["redone"] == [] and got["errors"] == 1
    assert [e for e in FLIGHT.events() if e["kind"] == "blocksync_pool_error"]
    assert calls and all(d == torch.device("cpu") for d in calls)


def test_reactor_needs_a_card_or_device_cpu(monkeypatch):
    gen, _, _ = exec_chain()
    node = port_node(gen)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        preactor.BlocksyncReactor(node["state"], node["exec"], node["blocks"], True)
    with pytest.raises(ValueError, match="prefetch_depth"):
        preactor.BlocksyncReactor(node["state"], node["exec"], node["blocks"], True,
                                  prefetch_depth=-1, device="cpu")
