"""The port's tx and block indexers and the IndexerService
(cometbft_tpu_torch/state/txindex.py) and its Pruner with the
executor's retain-height hook (state/pruner.py, state/execution.py)
against the reference's (cometbft_tpu/state/...), which imports no jax
for these modules.

The chain is ``tests/test_torch_execution.exec_chain()``: 24 heights of
9 validators with kvstore txs, validator txs and signed envelopes, each
height's FinalizeBlock response from the reference's executor; each
package's stores and indexes are filled from it (the port's carried by
the wire bytes).  Block events are the responses' own plus, for the
index images and queries, a few made from a seed.  Tolerance: exact --
the DBs' complete key -> value maps, the search results, the retain
heights and the pruned counts; a refusal's class and message.  Every
wait is bounded."""

import time

import pytest

from cometbft_tpu import state as rstate
from cometbft_tpu import store as rstore
from cometbft_tpu.abci import types as rabci
from cometbft_tpu.metrics import StateMetrics as RStateMetrics
from cometbft_tpu.state import pruner as rpruner
from cometbft_tpu.state import txindex as rtxindex
from cometbft_tpu.types.block import tx_hash
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import metrics as rumetrics
from cometbft_tpu_torch import state as pstate
from cometbft_tpu_torch import store as pstore
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.metrics import StateMetrics as PStateMetrics
from cometbft_tpu_torch.state import pruner as ppruner
from cometbft_tpu_torch.state import txindex as ptxindex
from cometbft_tpu_torch.types.part_set import BLOCK_PART_SIZE_BYTES
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import metrics as pumetrics
from tests.test_torch_execution import (HEIGHTS, exec_chain, image, port_bid, port_block,
                                        port_node, port_state, ref_node)
from tests.test_torch_types import outcome, port_commit, rng
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

WAIT = 30.0

REF = dict(abci=rabci, db=rdb, ix=rtxindex, pruner=rpruner, store=rstore, state=rstate,
           metrics=RStateMetrics, umetrics=rumetrics)
PORT = dict(abci=pabci, db=pdb, ix=ptxindex, pruner=ppruner, store=pstore, state=pstate,
            metrics=PStateMetrics, umetrics=pumetrics)


def port_parts(rec):
    return port_block(rec).make_part_set(BLOCK_PART_SIZE_BYTES)


def _resp(side: dict, rec):
    r = rec["resp"]
    return r if side is REF else pabci.FinalizeBlockResponse.decode(r.encode())


def _block_events(side: dict, h: int, g) -> tuple:
    """Block events made from ``g`` for height ``h`` (the kvstore app
    emits none): an indexed and an unindexed attribute."""
    A = side["abci"]
    return (A.Event(type="blk", attributes=(
        A.EventAttribute(key="mod", value=str(h % 3), index=True),
        A.EventAttribute(key="tag", value=g.bytes(2).hex(), index=bool(h % 2)),
        A.EventAttribute(key="note", value="x", index=False))),)


def _indexes(side: dict, extra_events: bool = True) -> dict:
    """``side``'s TxIndexer and BlockIndexer over one MemDB, with the
    chain's txs and block events of every height."""
    _, recs, _ = exec_chain()
    db = side["db"].MemDB()
    tx, blk = side["ix"].TxIndexer(db), side["ix"].BlockIndexer(db)
    g = rng(9800)
    for rec in recs[:HEIGHTS]:
        h, resp = rec["block"].header.height, _resp(side, rec)
        for i, t in enumerate(rec["block"].data.txs):
            tx.index(h, i, t, resp.tx_results[i])
        extra = _block_events(side, h, g) if extra_events else ()
        blk.index(h, tuple(resp.events) + extra)
    return dict(db=db, tx=tx, blk=blk)


def _stores(side: dict) -> dict:
    """``side``'s block and state stores with the chain's blocks, states
    and FinalizeBlock responses, and its indexes."""
    gen, recs, _ = exec_chain()
    n = dict(bdb=side["db"].MemDB(), sdb=side["db"].MemDB())
    n["blocks"], n["states"] = side["store"].BlockStore(n["bdb"]), side["state"].Store(n["sdb"])
    n["states"].save(recs[0]["before"] if side is REF else port_state(recs[0]["before"]))
    for rec in recs[:HEIGHTS]:
        h = rec["block"].header.height
        if side is REF:
            n["blocks"].save_block(rec["block"], rec["parts"], rec["commit"])
            n["states"].save(rec["after"])
        else:
            n["blocks"].save_block(port_block(rec), port_parts(rec),
                                   port_commit(rec["commit"]))
            n["states"].save(port_state(rec["after"]))
        n["states"].save_finalize_block_response(h, _resp(side, rec))
    n.update(_indexes(side))
    return n


def test_index_images_equal_the_reference():
    """Both indexers over one DB, the chain's txs with their results and
    each height's block events: the DB images key for key."""
    r, p = _indexes(REF), _indexes(PORT)
    assert len(image(r["db"])) > 100
    assert image(p["db"]) == image(r["db"])
    _, recs, _ = exec_chain()
    for rec in recs[:HEIGHTS]:
        for t in rec["block"].data.txs:
            got, want = p["tx"].get(tx_hash(t)), r["tx"].get(tx_hash(t))
            assert (got["height"], got["index"], got["tx"], got["result"].encode()) == \
                (want["height"], want["index"], want["tx"], want["result"].encode())
    assert p["tx"].get(b"\x00" * 32) is None and r["tx"].get(b"\x00" * 32) is None


TX_QUERIES = ["tx.height = 5", "tx.height > 20", "tx.height >= 3 AND tx.height < 6",
              "app.key = 'k10-0'", "app.key EXISTS", "app.noindex_key = 'k10-0'",
              "app.key CONTAINS '-1'", "tx.height < 0", "tm.event = 'Tx'"]
BLOCK_QUERIES = ["block.height = 4", "blk.mod = '1'", "block.height > 10 AND blk.mod = '2'",
                 "blk.note = 'x'", "blk.tag EXISTS", "block.height <= 3"]


def _tx_rows(rows) -> list:
    return [(e["height"], e["index"], e["tx"], e["result"].encode()) for e in rows]


@pytest.mark.parametrize("limit", (100, 3))
@pytest.mark.parametrize("query", TX_QUERIES + ["hash"])
def test_tx_search_equals_the_reference(query, limit):
    r, p = _indexes(REF), _indexes(PORT)
    if query == "hash":
        _, recs, _ = exec_chain()
        query = f"tx.hash = '{tx_hash(recs[9]['block'].data.txs[0]).hex().upper()}'"
    want = _tx_rows(r["tx"].search(query, limit=limit))
    assert _tx_rows(p["tx"].search(query, limit=limit)) == want
    assert outcome(lambda: p["tx"].search(query + " AND")) == \
        outcome(lambda: r["tx"].search(query + " AND"))


@pytest.mark.parametrize("limit", (100, 2))
@pytest.mark.parametrize("query", BLOCK_QUERIES)
def test_block_search_equals_the_reference(query, limit):
    r, p = _indexes(REF), _indexes(PORT)
    assert p["blk"].search(query, limit=limit) == r["blk"].search(query, limit=limit)


def test_the_null_indexer_is_the_references():
    for side in (REF, PORT):
        n = side["ix"].NullIndexer()
        assert (n.index(1, 0, b"", None), n.get(b"x"), n.search("tx.height = 1"),
                n.prune(5)) == (None, None, [], None)


def _wait(cond, what: str) -> None:
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_indexer_service_on_the_port_event_bus():
    """The port's IndexerService on its EventBus while the port's
    executor replays the chain: the index it writes is, key for key, the
    reference's indexers fed each height's txs and events directly."""
    gen, recs, _ = exec_chain()
    n = port_node(gen)
    n["exec"].validate_block = lambda state, block: None
    n["bus"].start()
    db = pdb.MemDB()
    svc = ptxindex.IndexerService(ptxindex.TxIndexer(db), ptxindex.BlockIndexer(db), n["bus"])
    svc.start()
    try:
        state = n["state"]
        for rec in recs[:HEIGHTS]:
            state = n["exec"].apply_block(state, port_bid(rec["bid"]), port_block(rec))
        _wait(lambda: db.get(b"blk/height/" + HEIGHTS.to_bytes(8, "big")) is not None,
              "the last height was not indexed")
    finally:
        svc.stop()
        n["bus"].stop()
    assert not svc._thread.is_alive()
    assert image(db) == image(_indexes(REF, extra_events=False)["db"])


def test_indexer_service_indexes_a_block_whole():
    """A block of 40 txs through each executor's event publication: the
    port's service has indexed every tx within a second (the block and
    its txs as one batch, as CometBFT's); the reference's takes one Tx
    event per 0.1 s poll while no block arrives (its txindex.py:324-340) and has
    fewer then.  Both end with the same index."""
    gen, recs, _ = exec_chain()
    state = recs[0]["before"]
    txs = tuple(b"whole%d=%d" % (i, i) for i in range(40))
    block = state.make_block(1, txs, recs[0]["block"].last_commit, (),
                             state.validators.get_proposer().address, state.last_block_time_ns)
    resp = rabci.FinalizeBlockResponse(tx_results=tuple(
        rabci.ExecTxResult(code=0, data=t, events=(rabci.Event(type="app", attributes=(
            rabci.EventAttribute(key="key", value=t.decode(), index=True),)),)) for t in txs))
    bid = recs[0]["bid"]
    dbs, svcs, nodes = {}, {}, {}
    for name, side in (("ref", REF), ("port", PORT)):
        node = ref_node(gen) if side is REF else port_node(gen)
        node["bus"].start()
        dbs[name] = side["db"].MemDB()
        svcs[name] = side["ix"].IndexerService(side["ix"].TxIndexer(dbs[name]),
                                               side["ix"].BlockIndexer(dbs[name]), node["bus"])
        svcs[name].start()
        nodes[name] = node
    try:
        t0 = time.monotonic()
        nodes["ref"]["exec"]._fire_events(block, bid, resp)
        nodes["port"]["exec"]._fire_events(port_block(dict(block=block)), port_bid(bid),
                                           pabci.FinalizeBlockResponse.decode(resp.encode()))
        rows = {k: (lambda db=db: sum(1 for _ in db.prefix_iterator(b"txh/")))
                for k, db in dbs.items()}
        _wait(lambda: rows["port"]() == 40, "the port's service did not index the block")
        assert time.monotonic() - t0 < 1.0
        assert rows["ref"]() < 40
        _wait(lambda: rows["ref"]() == 40, "the reference's service did not catch up")
    finally:
        for name in ("ref", "port"):
            svcs[name].stop()
            nodes[name]["bus"].stop()
    assert image(dbs["port"]) == image(dbs["ref"])


def _retain_script(side: dict) -> list:
    n = _stores(side)
    P = side["pruner"]
    out = []
    p = P.Pruner(n["states"], n["blocks"])
    out.append(p.get_application_retain_height())
    p.set_application_retain_height(7)
    p.set_application_retain_height(5)       # never moves backwards
    out.append(p.get_application_retain_height())
    out.append(outcome(lambda: p.set_companion_block_retain_height(0)))
    out.append(outcome(lambda: p.set_companion_block_retain_height(HEIGHTS + 1)))
    out.append(outcome(lambda: p.set_application_retain_height(HEIGHTS + 5)))
    out.append(p.effective_retain_height())
    c = P.Pruner(n["states"], n["blocks"], companion_enabled=True)
    out.append(c.effective_retain_height())  # the companion has not spoken
    c.set_companion_block_retain_height(4)
    out.append((c.effective_retain_height(), c.get_companion_block_retain_height()))
    c.set_companion_block_retain_height(9)
    out.append(c.effective_retain_height())
    c.set_abci_results_retain_height(3)
    again = P.Pruner(n["states"], n["blocks"], companion_enabled=True)   # persisted
    out.append((again.get_application_retain_height(),
                again.get_companion_block_retain_height(),
                again.get_abci_results_retain_height(), again.effective_retain_height()))
    out.append(image(n["sdb"]) == image(_stores(side)["sdb"]))
    out.append(sorted(k for k in image(n["sdb"]) if k.startswith(b"pruner/")))
    return out


def test_retain_heights_persist_and_combine_as_the_reference():
    """The app's and the companion's retain heights: the same refusals,
    the same effective minimum with and without the companion, persisted
    in the state DB under the same keys."""
    got = _retain_script(PORT)
    assert got == _retain_script(REF)
    assert got[1] == 7 and got[5] == 7 and got[6] == 0 and got[7] == (4, 4) and got[8] == 7
    assert got[9] == (7, 9, 3, 7)


@pytest.mark.parametrize("retain", (2, 12, HEIGHTS))
def test_pruned_images_equal_the_reference(retain):
    """One pass of each package's pruner at ``retain`` over its stores
    and indexes (and the ABCI results' own axis at half of it): the same
    counts and base, and the block DB, the state DB and the index DB
    key for key; the stored top still loads."""
    out = {}
    for name, side in (("ref", REF), ("port", PORT)):
        n = _stores(side)
        reg = side["umetrics"].Registry()
        p = side["pruner"].Pruner(n["states"], n["blocks"], n["tx"], n["blk"],
                                  metrics=side["metrics"](reg))
        p.set_application_retain_height(retain)
        p.set_abci_results_retain_height(max(retain // 2, 1))
        counts = p.prune_once()
        out[name] = (counts, n["blocks"].base(), image(n["bdb"]), image(n["sdb"]),
                     image(n["db"]), [ln for ln in reg.expose().splitlines()
                                      if "pruned_blocks" in ln])
        assert n["blocks"].load_block(HEIGHTS) is not None
        assert n["blocks"].load_block(retain - 1) is None or retain == 1
        assert p.prune_once() == (0, retain)
    assert out["port"] == out["ref"]
    assert out["port"][0] == (retain - 1, retain)


def test_the_pruner_service_prunes_on_its_thread():
    """Started with a short interval, the port's pruner prunes once a
    retain height arrives, and its thread ends with ``stop``."""
    n = _stores(PORT)
    p = ppruner.Pruner(n["states"], n["blocks"], n["tx"], n["blk"], interval_s=0.05)
    p.start()
    try:
        p.set_application_retain_height(10)
        _wait(lambda: n["blocks"].base() == 10, "the pruner did not prune")
        _wait(lambda: not any(
            int.from_bytes(k[4:12], "big") < 10 for k, _ in n["db"].prefix_iterator(b"txh/")),
            "the tx index kept rows below the retain height")
    finally:
        p.stop()
    assert not p._thread.is_alive()


def _hook_script(side: dict) -> list:
    """The chain replayed by ``side``'s executor with a pruner wired in
    and an app whose Commit asks to retain the last 3 heights, and from
    height 12 on only the committed one; block h is saved after it is
    applied from height 8 on, so from 12 on the pruner refuses a retain
    height above the store's (the executor logs it and goes on)."""
    gen, recs, _ = exec_chain()
    n = ref_node(gen) if side is REF else port_node(gen)
    n["exec"].validate_block = lambda state, block: None
    p = side["pruner"].Pruner(n["states"], n["blocks"])
    n["exec"].pruner = p
    commit = n["app"].commit

    def retaining():
        resp = commit()
        h = n["app"].height
        return type(resp)(retain_height=h if h >= 12 else max(h - 3, 0))

    n["app"].commit = retaining
    state, out = n["state"], []
    for rec in recs[:HEIGHTS]:
        h = rec["block"].header.height
        block = rec["block"] if side is REF else port_block(rec)
        parts = rec["parts"] if side is REF else port_parts(rec)
        commit_ = rec["commit"] if side is REF else port_commit(rec["commit"])
        bid = rec["bid"] if side is REF else port_bid(rec["bid"])
        if h < 8:
            n["blocks"].save_block(block, parts, commit_)
        state = n["exec"].apply_block(state, bid, block)
        if h >= 8:
            n["blocks"].save_block(block, parts, commit_)
        out.append((h, n["exec"].retain_height, p.get_application_retain_height()))
    return out


def test_the_executor_hands_the_retain_height_to_the_pruner_as_the_reference():
    got = _hook_script(PORT)
    assert got == _hook_script(REF)
    assert got[3] == (4, 1, 1) and got[10] == (11, 8, 8)
    assert got[-1] == (HEIGHTS, HEIGHTS, 8)
