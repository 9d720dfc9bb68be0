"""The port's statesync (cometbft_tpu_torch/statesync: the messages, the
snapshot pool and chunk queue, the syncer, the light-client state
provider and the reactor; StateSyncMetrics) against the reference's
(cometbft_tpu/statesync), which imports no jax for these modules.

The same inputs go to both packages: every message is encoded by each
package and decoded by the other, malformed bytes are refused alike; a
scripted sequence of snapshot advertisements, rejections, peer
removals, chunk arrivals and bounded waits gives the same outcomes in
both pools and queues.  The slice whole, over 127.0.0.1 TCP, both ways:
a fresh node of one package restores the chain of tests/
test_torch_execution.py (9 validators, 24 executed heights) from a
source node of the other package whose KVStoreApp takes one snapshot,
at height 21 of 25 -- its light client verifies the headers at the snapshot
height H and at H + 1 and H + 2 against the source's stores, it fetches
and applies the snapshot's chunks, hands the state to blocksync, and
syncs to the top.  It ends with the source's state, app hash and
blocks.  Tolerance: exact.  The reference verifies with
CMT_TPU_DISABLE_DEVICE_VERIFY=1 (its host verifier), the port on
``device="cpu"``.  Every wait is bounded; every node is stopped in a
``finally``."""

import threading

import pytest

from cometbft_tpu.statesync import messages as rmsg
from cometbft_tpu.statesync import syncer as rsyncer
from cometbft_tpu_torch.statesync import messages as pmsg
from cometbft_tpu_torch.statesync import syncer as psyncer
from tests.test_torch_types import outcome, rng
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

WAIT = 60.0
SNAPSHOT_EVERY = 21     # one snapshot, at 21 of the chain's 25 stored heights
PERIOD = 100 * 365 * 24 * 3600 * 10**9


# -- the messages ----------------------------------------------------------------

def _messages(mod, g) -> list:
    return [
        mod.SnapshotsRequest(),
        mod.SnapshotsResponse(height=int(g.integers(1, 1 << 40)), format=1,
                              chunks=int(g.integers(1, 9)), hash=g.bytes(32),
                              metadata=g.bytes(int(g.integers(0, 40)))),
        mod.SnapshotsResponse(height=0, format=0, chunks=0, hash=b""),
        mod.ChunkRequest(height=int(g.integers(1, 1 << 30)), format=2,
                         index=int(g.integers(0, 100))),
        mod.ChunkResponse(height=5, format=1, index=3, chunk=g.bytes(700)),
        mod.ChunkResponse(height=5, format=1, index=4, missing=True),
    ]


@pytest.mark.parametrize("seed", range(3))
def test_messages_encode_alike_and_decode_both_ways(seed):
    ref = [rmsg.encode_ss_message(m) for m in _messages(rmsg, rng(1800 + seed))]
    port = [pmsg.encode_ss_message(m) for m in _messages(pmsg, rng(1800 + seed))]
    assert port == ref
    for raw in ref:
        assert pmsg.encode_ss_message(pmsg.decode_ss_message(raw)) == raw
        assert rmsg.encode_ss_message(rmsg.decode_ss_message(raw)) == raw
    assert (pmsg.SNAPSHOT_CHANNEL, pmsg.CHUNK_CHANNEL) == (rmsg.SNAPSHOT_CHANNEL,
                                                           rmsg.CHUNK_CHANNEL)
    assert outcome(lambda: pmsg.encode_ss_message(object())) == \
        outcome(lambda: rmsg.encode_ss_message(object()))


@pytest.mark.parametrize("raw", [b"", b"\x0a", b"\x2a\x00", b"\x12\x03\x08\x01", b"\xff\xff",
                                 b"\x1a\x02\x08\x80"])
def test_malformed_messages_are_refused_alike(raw):
    def decoded(mod):
        got = outcome(lambda: mod.decode_ss_message(raw))
        return got if got != ("ok",) else repr(mod.decode_ss_message(raw)).split(".")[-1]

    assert decoded(pmsg) == decoded(rmsg)


# -- the snapshot pool and the chunk queue -----------------------------------------

def _pool_script(mod, g) -> list:
    """A seeded sequence of pool operations -> each one's result and the
    pool's ranking after it."""
    snaps = [mod.Snapshot(height=int(g.integers(1, 6)) * 10, format=1,
                          chunks=int(g.integers(1, 4)), hash=g.bytes(4)) for _ in range(6)]
    snaps.append(mod.Snapshot(height=snaps[0].height, format=1, chunks=snaps[0].chunks + 1,
                              hash=snaps[0].hash))      # same hash, another chunk count
    pool, out = mod.SnapshotPool(), []
    peers = ["p%d" % i for i in range(4)]
    for _ in range(40):
        op = int(g.integers(0, 10))
        s = snaps[int(g.integers(0, len(snaps)))]
        if op < 6:
            res = pool.add(peers[int(g.integers(0, 4))], s)
        elif op < 7:
            res = pool.reject(s)
        elif op < 8:
            res = pool.remove_peer(peers[int(g.integers(0, 4))])
        else:
            b = pool.best()
            res = None if b is None else (b.key(), sorted(pool.peers_for(b)))
        out.append((op, res, pool.size()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_snapshot_pool_follows_the_reference(seed):
    assert _pool_script(psyncer, rng(1810 + seed)) == _pool_script(rsyncer, rng(1810 + seed))


def _queue_script(mod) -> list:
    q = mod.ChunkQueue(mod.Snapshot(height=9, format=1, chunks=3, hash=b"h"))
    out = [q.add(0, b"zero"), q.add(0, b"dup"), q.add(7, b"out"), q.add(-1, b"neg"),
           q.get(0), q.get(1), q.wait_for(0, 0.01), q.wait_for(2, 0.02)]
    t = threading.Timer(0.02, lambda: q.add(2, b"two"))
    t.start()
    out.append(q.wait_for(2, 5.0))
    t.join()
    q.discard(0)
    out += [q.get(0), q.add(0, b"again"), q.get(0)]
    return out


def test_chunk_queue_follows_the_reference():
    assert _queue_script(psyncer) == _queue_script(rsyncer)


# -- the slice whole: a restore over TCP, both ways ----------------------------------

def _pkg(name: str) -> dict:
    import importlib

    def m(path):
        return importlib.import_module(f"{name}.{path}")

    return dict(port=name.endswith("_torch"), kv=m("abci.kvstore"), abci=m("abci.types"),
                proxy=m("proxy"), state=m("state"), store=m("store"), db=m("utils.db"),
                genesis=m("types.genesis"), consensus=m("consensus"),
                execution=m("state.execution"), mempool=m("mempool"), bs=m("blocksync.reactor"),
                ss=m("statesync"), light=m("light.client"), lprov=m("light.provider"),
                lstore=m("light.store"), util=m("p2p.test_util"), log=m("utils.log"))


REF, PORT = _pkg("cometbft_tpu"), _pkg("cometbft_tpu_torch")


def _stores(side: dict) -> tuple:
    """The execution test's chain in ``side``'s stores: (genesis, block
    store, state store), each over its own MemDB copy."""
    from tests.test_torch_execution import exec_chain, image

    gen, _, src = exec_chain()
    bdb, sdb = side["db"].MemDB(), side["db"].MemDB()
    for db, img in ((bdb, image(src["bdb"])), (sdb, image(src["sdb"]))):
        for k, v in img.items():
            db.set(k, v)
    pgen = side["genesis"].GenesisDoc.from_json(gen.to_json())
    return pgen, side["store"].BlockStore(bdb), side["state"].Store(sdb)


def _source(side: dict) -> dict:
    """A source node of ``side``: the chain's stores, and a KVStoreApp
    (a snapshot every SNAPSHOT_EVERY heights) that the Handshaker brings
    to the top by replaying every stored block; its switch serves
    statesync and blocksync."""
    kw = dict(device="cpu") if side["port"] else {}
    nop = side["log"].NopLogger()
    gen, blocks, states = _stores(side)
    app = side["kv"].KVStoreApp(side["db"].MemDB(), snapshot_interval=SNAPSHOT_EVERY)
    conns = side["proxy"].new_app_conns(side["proxy"].local_client_creator(app))
    state = side["consensus"].Handshaker(states, states.load(), blocks, gen, logger=nop,
                                         **kw).handshake(conns)
    ss = side["ss"].StatesyncReactor(conns.snapshot, enabled=False, logger=nop)
    bs = side["bs"].BlocksyncReactor(state, None, blocks, False, logger=nop, **kw)
    sw = side["util"].make_switch(moniker="source", reactors={"STATESYNC": ss, "BLOCKSYNC": bs})
    return dict(gen=gen, blocks=blocks, states=states, app=app, state=state, sw=sw)


class Recorder:
    def __init__(self) -> None:
        self.states: list = []
        self.done = threading.Event()

    def switch_to_consensus(self, state) -> None:
        self.states.append(state)
        self.done.set()


def _syncer(side: dict, gen_json: str) -> dict:
    """A fresh node of ``side``: empty stores, a fresh KVStoreApp, a
    light client over the chain (a primary and a witness over its own
    copies of the source's stores), a StatesyncReactor whose completion
    bootstraps the stores and starts blocksync, as the reference's node
    does (node/__init__.py ``_on_statesync_complete``)."""
    kw = dict(device="cpu") if side["port"] else {}
    nop = side["log"].NopLogger()
    gen = side["genesis"].GenesisDoc.from_json(gen_json)
    n = dict(blocks=side["store"].BlockStore(side["db"].MemDB()),
             states=side["state"].Store(side["db"].MemDB()), recorder=Recorder())
    n["app"] = side["kv"].KVStoreApp(side["db"].MemDB())
    n["conns"] = side["proxy"].new_app_conns(side["proxy"].local_client_creator(n["app"]))
    providers = []
    for _ in range(2):
        _, pblocks, pstates = _stores(side)
        providers.append(side["lprov"].NodeProvider(gen.chain_id, pblocks, pstates))
    trust = side["light"].TrustOptions(period_ns=PERIOD, height=1,
                                       hash=providers[0].light_block(1).hash())
    lc = side["light"].Client(gen.chain_id, trust, providers[0], providers[1:],
                              side["lstore"].LightStore(side["db"].MemDB()), logger=nop, **kw)
    provider = side["ss"].LightClientStateProvider(
        lc, consensus_params_fn=providers[0].consensus_params, logger=nop)
    exe = side["execution"].BlockExecutor(n["states"], n["conns"].consensus,
                                          side["mempool"].NopMempool(), block_store=n["blocks"],
                                          logger=nop, **kw)
    n["bs"] = side["bs"].BlocksyncReactor(side["state"].State.from_genesis(gen), exe,
                                          n["blocks"], False, consensus_reactor=n["recorder"],
                                          logger=nop, **kw)

    def on_complete(state, commit):
        n["states"].bootstrap(state)
        n["blocks"].save_seen_commit(state.last_block_height, commit)
        n["restored"] = state
        n["bs"].start_sync(state)

    n["ss"] = side["ss"].StatesyncReactor(n["conns"].snapshot, enabled=True,
                                          state_provider=provider, on_complete=on_complete,
                                          discovery_time=1.0, logger=nop)
    n["sw"] = side["util"].make_switch(moniker="syncer",
                                       reactors={"STATESYNC": n["ss"], "BLOCKSYNC": n["bs"]})
    return n


def _state_summary(s) -> tuple:
    return (s.chain_id, s.last_block_height, s.last_block_id.hash, s.last_block_time_ns,
            s.validators.hash(), s.next_validators.hash(), s.last_validators.hash(),
            s.consensus_params.hash(), s.last_results_hash, s.app_hash)


@pytest.mark.parametrize("syncer_side,source_side", [(PORT, REF), (REF, PORT)],
                         ids=["port_restores_from_reference", "reference_restores_from_port"])
def test_a_node_restores_from_the_other_packages_snapshots(monkeypatch, syncer_side,
                                                           source_side):
    from tests.test_torch_execution import exec_chain

    for side in (PORT, REF):
        monkeypatch.setattr(side["bs"], "SWITCH_TO_CONSENSUS_INTERVAL", 0.05)
    gen, recs, _ = exec_chain()
    src = _source(source_side)
    n = _syncer(syncer_side, gen.to_json())
    top = src["blocks"].height()
    try:
        src["sw"].start()
        n["sw"].start()
        n["sw"].dial_peer_with_address(src["sw"].transport.listen_addr)
        assert n["ss"].sync_done.wait(WAIT) and n["ss"].sync_error is None, n["ss"].sync_error
        assert n["recorder"].done.wait(WAIT), n["blocks"].height()
    finally:
        for sw in (n["sw"], src["sw"]):
            if sw.is_running():
                sw.stop()
    restored = n["restored"].last_block_height
    assert restored == SNAPSHOT_EVERY and restored + 2 <= top
    final = n["recorder"].states[0]
    assert final.last_block_height == top - 1
    want = recs[top - 2]["after"]                                     # the state at top - 1
    assert _state_summary(final) == _state_summary(want)
    info = n["app"].info(syncer_side["abci"].InfoRequest())
    assert (info.last_block_height, info.last_block_app_hash) == (top - 1, want.app_hash)
    assert n["blocks"].base() == restored + 1
    for h in range(restored + 1, top):
        assert n["blocks"].load_block_meta(h).block_id.encode() == \
            src["blocks"].load_block_meta(h).block_id.encode()
    assert n["ss"].metrics is not None and not n["ss"].enabled
