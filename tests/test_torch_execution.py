"""The port's state execution (cometbft_tpu_torch/state/execution.py, the
state store's FinalizeBlock responses, the local proxy, NopMempool and the
event bus) against the reference's (cometbft_tpu/...), which imports no
jax for these modules.

``exec_chain()`` builds one chain with the reference's own executor over
its KVStoreApp (validation off: the source trusts its blocks), 9
validators, ~4 txs a block with validator txs, malformed validator txs
and signed envelopes mixed in; every validator of a height's set signs
the height's commit with its own timestamp.  The port replays it block by
block with its executor over its app and stores (``device="cpu"``: the
host tier checks every LastCommit), each block carried by its wire bytes.
Tolerance: exact -- ``encode_state`` bytes, the state DB's complete
key -> value map, the app's persisted record, the FinalizeBlock
responses' codec bytes and the event bus's published sequence after
every height; a refused block is the same exception class and message.
The reference verifies with CMT_TPU_DISABLE_DEVICE_VERIFY=1 (its host
verifier: no JAX compile).

``exec_chain`` and the node helpers are shared with
tests/test_torch_blocksync.py."""

import base64
from dataclasses import replace
from functools import lru_cache

import pytest
import torch

from cometbft_tpu import proxy as rproxy
from cometbft_tpu import state as rstate
from cometbft_tpu.abci import kvstore as rkv
from cometbft_tpu.abci import types as rabci
from cometbft_tpu.mempool import NopMempool as RNopMempool
from cometbft_tpu.mempool import ingest as ringest
from cometbft_tpu.state import execution as rexec
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types import event_bus as rbus
from cometbft_tpu.types import genesis as rgenesis
from cometbft_tpu.types.part_set import BLOCK_PART_SIZE_BYTES
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import log as rlog
from cometbft_tpu.utils import pubsub as rpubsub
from cometbft_tpu_torch import proxy as pproxy
from cometbft_tpu_torch import state as pstate
from cometbft_tpu_torch.abci import kvstore as pkv
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.mempool import NopMempool as PNopMempool
from cometbft_tpu_torch.state import execution as pexec
from cometbft_tpu_torch.store import BlockStore as PBlockStore
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.types import event_bus as pbus
from cometbft_tpu_torch.types import genesis as pgenesis
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import log as plog
from cometbft_tpu_torch.utils import pubsub as ppubsub
from tests.test_torch_types import CHAIN, T0, outcome, ref_keys, rng, signed_precommit
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

BLOCK_NS = 5 * 10**9
NVAL = 9
HEIGHTS = 24
EVERY = 10          # a val: tx pair (a newcomer in, an original out) every EVERY heights
EVENTS_AT = 10      # a rotation height: tx events and validator updates


# -- the chain ---------------------------------------------------------------

def kv_txs(g, h: int) -> list[bytes]:
    """2-4 kvstore txs ``k<h>-<i>=<hex>``."""
    return [b"k%d-%d=%s" % (h, i, g.bytes(int(g.integers(8, 30))).hex().encode())
            for i in range(int(g.integers(2, 5)))]


def odd_txs(h: int, g, env_key) -> list[bytes]:
    """Txs the app refuses or opens at fixed heights: malformed validator
    txs and non-txs at 3, signed envelopes (valid, forged, malformed) at 4."""
    if h == 3:
        return [b"val:not-base64!10", b"val:%s!5" % base64.b64encode(bytes(31)),
                b"val:%s!-3" % base64.b64encode(bytes(range(32))), b"val:nobang",
                b"novalue", b"\xff\xfe=1"]
    if h == 4:
        good = ringest.make_signed_tx(env_key, b"sk=sv")
        forged = good[:-1] + b"w"
        return [good, forged, b"stx:zz", b"stx:" + b"0" * 64 + b"1" * 128 + b"x"]
    return []


def ref_node(gen, validate: bool = False):
    """The reference's node pieces over MemDBs: stores (the genesis state
    saved), a KVStoreApp after InitChain, the local proxy, an EventBus
    with an ALL subscription, and the executor (``validate=False``: the
    source trusts its own blocks)."""
    n = dict(bdb=rdb.MemDB(), sdb=rdb.MemDB(), adb=rdb.MemDB())
    n["blocks"], n["states"] = RBlockStore(n["bdb"]), rstate.Store(n["sdb"])
    n["state"] = rstate.State.from_genesis(gen)
    n["states"].save(n["state"])
    n["app"] = rkv.KVStoreApp(n["adb"])
    n["app"].init_chain(rabci.InitChainRequest(chain_id=gen.chain_id, validators=tuple(
        rabci.ValidatorUpdate("ed25519", v.pub_key.bytes(), v.power) for v in gen.validators)))
    n["conns"] = rproxy.new_app_conns(rproxy.local_client_creator(n["app"]))
    n["bus"] = rbus.EventBus()
    n["sub"] = n["bus"].subscribe("test", rpubsub.ALL, capacity=10000)
    n["exec"] = rexec.BlockExecutor(n["states"], n["conns"].consensus, RNopMempool(),
                                    block_store=n["blocks"], event_bus=n["bus"],
                                    logger=rlog.NopLogger())
    if not validate:
        n["exec"].validate_block = lambda state, block: None
    return n


def port_node(gen, device="cpu"):
    """The same pieces of the port, ``gen`` carried by its JSON."""
    pgen = pgenesis.GenesisDoc.from_json(gen.to_json())
    n = dict(bdb=pdb.MemDB(), sdb=pdb.MemDB(), adb=pdb.MemDB())
    n["blocks"], n["states"] = PBlockStore(n["bdb"]), pstate.Store(n["sdb"])
    n["state"] = pstate.State.from_genesis(pgen)
    n["states"].save(n["state"])
    n["app"] = pkv.KVStoreApp(n["adb"])
    n["app"].init_chain(pabci.InitChainRequest(chain_id=pgen.chain_id, validators=tuple(
        pabci.ValidatorUpdate("ed25519", v.pub_key.bytes(), v.power) for v in pgen.validators)))
    n["conns"] = pproxy.new_app_conns(pproxy.local_client_creator(n["app"]))
    n["bus"] = pbus.EventBus()
    n["sub"] = n["bus"].subscribe("test", ppubsub.ALL, capacity=10000)
    n["exec"] = pexec.BlockExecutor(n["states"], n["conns"].consensus, PNopMempool(),
                                    block_store=n["blocks"], event_bus=n["bus"],
                                    logger=plog.NopLogger(), device=device)
    return n


def image(db) -> dict:
    return dict(db.iterator())


def drain(sub) -> list:
    """The published sequence so far: (data class name, events)."""
    out = []
    while (msg := sub.try_next()) is not None:
        out.append((type(msg.data).__name__, msg.events))
    return out


@lru_cache(maxsize=1)
def exec_chain():
    """The reference chain: (genesis, one record per height 1..HEIGHTS+1,
    the source node).  A record holds the block, its part set, BlockID
    and commit, the state before it and, for heights up to HEIGHTS (block
    HEIGHTS+1 only carries the last commit), the state after it, the
    FinalizeBlock response, the state DB image, the app's record and the
    event sequence; height HEIGHTS's also the block DB image after its
    save."""
    g = rng(9100)
    keys = ref_keys(g, NVAL + HEIGHTS // EVERY + 2)
    vals_keys, spare = keys[:NVAL], list(keys[NVAL:-1])
    env_key = keys[-1]
    by_addr = {k.pub_key().address(): k for k in keys}
    gen = rgenesis.GenesisDoc(
        chain_id=CHAIN, genesis_time_ns=T0,
        validators=tuple(rgenesis.GenesisValidator(k.pub_key(), 10) for k in vals_keys))
    node = ref_node(gen)
    originals = sorted(k.pub_key().bytes() for k in vals_keys)
    state, last_commit, recs = node["state"], None, []
    drain(node["sub"])
    for h in range(1, HEIGHTS + 2):
        txs = kv_txs(g, h) + odd_txs(h, g, env_key)
        if h <= HEIGHTS and h % EVERY == 0:
            new = spare.pop(0).pub_key().bytes()
            gone = originals.pop(h % len(originals))
            txs += [b"val:%s!10" % base64.b64encode(new), b"val:%s!0" % base64.b64encode(gone)]
        t_ns = (state.last_block_time_ns if h == 1
                else rexec.median_time(last_commit, state.last_validators))
        block = state.make_block(h, tuple(txs),
                                 last_commit if last_commit is not None else rblock.Commit(), (),
                                 state.validators.get_proposer().address, t_ns)
        parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)
        bid = rblock.BlockID(hash=block.hash(), part_set_header=parts.header)
        commit = rblock.Commit(height=h, round=0, block_id=bid, signatures=tuple(
            signed_precommit(by_addr[v.address], i, bid, h, 0,
                             t_ns + BLOCK_NS // 2 + int(g.integers(0, 10**9))).commit_sig()
            for i, v in enumerate(state.validators.validators)))
        rec = dict(block=block, parts=parts, bid=bid, commit=commit, before=state)
        if h <= HEIGHTS:
            state = node["exec"].apply_block(state, bid, block)
            rec.update(after=state, resp=node["states"].load_finalize_block_response(h),
                       state_image=image(node["sdb"]), app_record=node["adb"].get(
                           b"kvstore:state"), events=drain(node["sub"]))
        node["blocks"].save_block(block, parts, commit)
        if h == HEIGHTS:
            rec["block_image"] = image(node["bdb"])
        recs.append(rec)
        last_commit = commit
    return gen, recs, node


def port_block(rec):
    return pcodec.decode_block(rcodec.encode_block(rec["block"]))


def port_bid(bid):
    return pcodec.decode_block_id(bid.encode())


def port_state(s):
    return pstate.decode_state(rstate.encode_state(s))


# -- replay --------------------------------------------------------------------

def test_port_replays_the_reference_chain():
    """Each block through the port's apply_block: the state, the state DB,
    the app's record and hash, the stored response and the event
    sequence equal the reference's at every height."""
    gen, recs, src = exec_chain()
    node = port_node(gen)
    drain(node["sub"])
    state = node["state"]
    assert pstate.encode_state(state) == rstate.encode_state(recs[0]["before"])
    for rec in recs[:HEIGHTS]:
        h = rec["block"].header.height
        state = node["exec"].apply_block(state, port_bid(rec["bid"]), port_block(rec))
        assert pstate.encode_state(state) == rstate.encode_state(rec["after"]), h
        assert image(node["sdb"]) == rec["state_image"], h
        assert node["adb"].get(b"kvstore:state") == rec["app_record"], h
        assert node["app"].app_hash == rabci.FinalizeBlockResponse.decode(
            rec["resp"].encode()).app_hash
        assert node["states"].load_finalize_block_response(h).encode() == rec["resp"].encode()
        assert drain(node["sub"]) == rec["events"], h
    assert node["app"].app_hash == src["app"].app_hash
    assert {k: node["app"].get(k) for k in src["app"]._kv} == src["app"]._kv
    assert node["exec"].last_transition_digest is None


def test_the_chain_exercises_rotations_refusals_and_envelopes():
    """The fixture is what the parity claims rest on: rotations reach the
    set, the odd txs are refused with the app's codes, the valid envelope
    executes, and the events height carries tx and validator events."""
    _, recs, _ = exec_chain()
    codes = [r.code for r in recs[2]["resp"].tx_results[-6:]]
    assert codes == [1, 1, 2, 1, 1, 1]
    env = [r.code for r in recs[3]["resp"].tx_results[-4:]]
    assert env == [0, 3, 3, 3]
    assert recs[EVENTS_AT - 1]["resp"].validator_updates
    kinds = [k for k, _ in recs[EVENTS_AT - 1]["events"]]
    assert kinds[:2] == ["EventDataNewBlock", "EventDataNewBlockHeader"]
    assert kinds[-1] == "EventDataValidatorSetUpdates" and "EventDataTx" in kinds
    changed = {r["after"].last_height_validators_changed for r in recs[:HEIGHTS]}
    assert {EVERY + 2, 2 * EVERY + 2} <= changed


def test_update_state_and_the_helpers_equal_the_reference():
    _, recs, src = exec_chain()
    for rec in recs[1:HEIGHTS]:
        resp = pabci.FinalizeBlockResponse.decode(rec["resp"].encode())
        got = pexec.update_state(port_state(rec["before"]), port_bid(rec["bid"]),
                                 port_block(rec), resp)
        assert pstate.encode_state(got) == rstate.encode_state(rec["after"])
        pvals = port_state(rec["before"]).last_validators
        lc = port_block(rec).last_commit
        assert pexec.median_time(lc, pvals) == rexec.median_time(
            rec["block"].last_commit, rec["before"].last_validators)
    for args in ((22020096, 0, 150), (1 << 20, 4096, 1024), (1000, 0, 3)):
        assert pexec.max_data_bytes(*args) == rexec.max_data_bytes(*args)
    pstore = pstate.Store(pdb.MemDB())
    for k, v in image(src["sdb"]).items():
        pstore._db.set(k, v)
    for rec in recs[1:6]:
        got = pexec.build_last_commit_info(port_block(rec), pstore)
        want = rexec.build_last_commit_info(rec["block"], src["states"])
        assert (got.round, [(v.validator_address, v.validator_power, v.block_id_flag)
                            for v in got.votes]) == \
            (want.round, [(v.validator_address, v.validator_power, v.block_id_flag)
                          for v in want.votes])
    assert outcome(lambda: pexec.median_time(pcodec.decode_commit(
        rcodec.encode_commit(rblock.Commit())), port_state(recs[0]["before"]).validators)) == \
        outcome(lambda: rexec.median_time(rblock.Commit(), recs[0]["before"].validators))


# -- validate_block's refusals -------------------------------------------------

AT = 8  # the refused block's height: a LastCommit of the same 9 keys


def _plant(fault: str, block):
    """The reference's ``block`` with one fault planted."""
    h = block.header
    if fault == "height":
        return replace(block, header=replace(h, height=h.height + 1))
    if fault == "time":
        return replace(block, header=replace(h, time_ns=h.time_ns + 1))
    if fault == "app_hash":
        return replace(block, header=replace(h, app_hash=b"\x01" * 32))
    if fault == "last_results_hash":
        return replace(block, header=replace(h, last_results_hash=b"\x02" * 32))
    if fault == "validators_hash":
        return replace(block, header=replace(h, validators_hash=b"\x03" * 32))
    if fault == "proposer":
        return replace(block, header=replace(h, proposer_address=b"\x04" * 20))
    if fault == "last_commit_signature":
        lc = block.last_commit
        cs = lc.signatures[0]
        sig = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
        bad = replace(lc, signatures=(replace(cs, signature=sig),) + lc.signatures[1:])
        return replace(block, last_commit=bad,
                       header=replace(h, last_commit_hash=bad.hash()))
    if fault == "last_commit_size":
        lc = block.last_commit
        bad = replace(lc, signatures=lc.signatures[:-1])
        return replace(block, last_commit=bad,
                       header=replace(h, last_commit_hash=bad.hash()))
    assert fault == "none"
    return block


FAULTS = ("none", "height", "time", "app_hash", "last_results_hash", "validators_hash",
          "proposer", "last_commit_signature", "last_commit_size")


@pytest.mark.parametrize("fault", FAULTS)
def test_validate_block_refuses_as_the_reference(fault):
    _, recs, _ = exec_chain()
    rec = recs[AT - 1]
    rblk = _plant(fault, rec["block"])
    want = outcome(lambda: rexec.validate_block(rec["before"], rblk))
    got = outcome(lambda: pexec.validate_block(
        port_state(rec["before"]), pcodec.decode_block(rcodec.encode_block(rblk)),
        device="cpu"))
    assert got == want
    assert (want == ("ok",)) == (fault == "none")


def test_initial_block_checks_equal_the_reference():
    _, recs, _ = exec_chain()
    rec = recs[0]
    for blk in (rec["block"], replace(rec["block"], header=replace(
            rec["block"].header, time_ns=rec["block"].header.time_ns + 1))):
        want = outcome(lambda: rexec.validate_block(rec["before"], blk))
        got = outcome(lambda: pexec.validate_block(
            port_state(rec["before"]), pcodec.decode_block(rcodec.encode_block(blk)),
            device="cpu"))
        assert got == want


# -- the device contract and the pieces around the executor --------------------

def test_executor_and_validate_block_need_a_card_or_device_cpu(monkeypatch):
    gen, recs, _ = exec_chain()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    node = port_node(gen, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexec.BlockExecutor(node["states"], node["conns"].consensus, PNopMempool())
    rec = recs[AT - 1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexec.validate_block(port_state(rec["before"]), port_block(rec))


def test_app_fault_latches_the_proxy_as_the_reference():
    """An app that raises poisons all four connections; the error
    callback fires once."""
    import time

    class Boom:
        def info(self, req):
            raise ValueError("app state unknown")

    got = []
    for mod, abci in ((rproxy, rabci), (pproxy, pabci)):
        fired = []
        conns = mod.new_app_conns(mod.local_client_creator(Boom()))
        conns.set_on_error(fired.append)
        first = outcome(lambda: conns.query.info(abci.InfoRequest()))
        second = outcome(lambda: conns.consensus.info(abci.InfoRequest()))
        for _ in range(200):
            if fired:
                break
            time.sleep(0.005)
        got.append((first, second, [repr(e) for e in fired]))
    assert got[0] == got[1]
    assert got[1][1][0] == "AbciClientError"


def test_nop_mempool_equals_the_reference():
    r, p = RNopMempool(), PNopMempool()
    assert outcome(lambda: p.check_tx(b"x")) == outcome(lambda: r.check_tx(b"x"))
    assert (p.size(), p.size_bytes(), p.contains(b"x"), p.reap_max_bytes_max_gas(10, 10),
            p.reap_max_txs(3), p.current_seq(), p.txs_after(0)) == \
        (r.size(), r.size_bytes(), r.contains(b"x"), r.reap_max_bytes_max_gas(10, 10),
         r.reap_max_txs(3), r.current_seq(), r.txs_after(0))
