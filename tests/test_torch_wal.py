"""The port's write-ahead log (cometbft_tpu_torch/wal: the file WAL and
its autofile ``Group``; state/determinism.py) against the reference's
(cometbft_tpu/...), which imports no jax for these modules.

The same records, drawn from a seed and written at the same (injected)
times, give byte-equal WAL files from both packages, and each package
reads the other's file; a corrupted record is refused at the same record
with the same error; a ``Group`` rotates and prunes to the same chunk
files; a transition digest has the same bytes and the same verdicts,
and each package's Handshaker, the guard on, checks a chain's replay
alike (a stored response tampered with: the same DivergenceError).
The slice whole: chip_smoke's crash harness (commit-N through consensus,
one validator and three stubs whose votes make the chain a function of
the seed) on the CPU: one port validator, with a file WAL and the
determinism guard on, is stopped in the middle of a height -- right
after its own precommit is written, before it is processed -- and a new
ConsensusState over the same WAL, stores, FilePV and app replays the
height and commits on; its chain equals an uninterrupted run's, and the
reference's under the same stub votes.  Tolerance: exact.  Every wait is
bounded; every node is stopped in a ``finally``."""

import os
from dataclasses import replace

import pytest

from cometbft_tpu import wal as rwal
from cometbft_tpu.abci import types as rabci
from cometbft_tpu.state import determinism as rdet
from cometbft_tpu.types import block as rblock
from cometbft_tpu.wal import autofile as rauto
from cometbft_tpu_torch import wal as pwal
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.state import determinism as pdet
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.wal import autofile as pauto
from tests.test_torch_types import outcome, rng

T0 = 1_700_000_000_000_000_000
KINDS = (rwal.KIND_MSG_INFO, rwal.KIND_TIMEOUT, rwal.KIND_END_HEIGHT,
         rwal.KIND_TRANSITION_DIGEST)


class Clock:
    """An injected ``now_ns``: T0, then 1 ms further at every read."""

    def __init__(self) -> None:
        self.t = T0

    def __call__(self) -> int:
        self.t += 1_000_000
        return self.t


def _script(tag: int, n: int = 40) -> list:
    """``n`` WAL writes drawn from a seed: (method, kind, data)."""
    g = rng(1700 + tag)
    out, height = [], 1
    for _ in range(n):
        c = int(g.integers(0, 10))
        if c < 5:
            out.append(("write", rwal.KIND_MSG_INFO, g.bytes(int(g.integers(0, 300)))))
        elif c < 7:
            out.append(("write_sync", rwal.KIND_MSG_INFO, g.bytes(int(g.integers(1, 120)))))
        elif c < 8:
            out.append(("write", rwal.KIND_TIMEOUT, g.bytes(int(g.integers(5, 20)))))
        elif c < 9:
            out.append(("write_end_height", None, height))
            height += 1
        else:
            out.append(("write_sync", rwal.KIND_TRANSITION_DIGEST,
                        b'{"digest":"%s","height":%d}' % (g.bytes(8).hex().encode(), height)))
    return out


def _write(mod, path: str, script, head_limit: int = 10 * 1024 * 1024) -> list:
    w = mod.WAL(path, head_size_limit=head_limit)
    w.start()
    for method, kind, data in script:
        if method == "write_end_height":
            w.write_end_height(data)
        else:
            getattr(w, method)(kind, data)
    w.flush_and_sync()
    recs = w.records()
    w.stop()
    return recs


def _files(path: str) -> dict:
    d = os.path.dirname(path)
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("tag,head_limit", [(0, 10 * 1024 * 1024), (1, 600), (2, 1)])
def test_wal_files_equal_the_reference_and_read_both_ways(monkeypatch, tmp_path, tag,
                                                           head_limit):
    script = _script(tag)
    for mod in (rwal, pwal):
        monkeypatch.setattr(mod, "now_ns", Clock())
    rpath, ppath = str(tmp_path / "ref" / "wal"), str(tmp_path / "port" / "wal")
    rrecs = _write(rwal, rpath, script, head_limit)
    precs = _write(pwal, ppath, script, head_limit)
    assert _files(ppath) == _files(rpath)
    if head_limit < 1000:
        assert len(_files(rpath)) > 1         # the group rotated
    assert [(r.time_ns, r.kind, r.data) for r in precs] == \
        [(r.time_ns, r.kind, r.data) for r in rrecs]
    # each package reads the other's file
    cross_p, cross_r = pwal.WAL(rpath), rwal.WAL(ppath)
    try:
        assert [(r.time_ns, r.kind, r.data) for r in cross_p.records()] == \
            [(r.time_ns, r.kind, r.data) for r in rrecs]
        for h in range(0, 8):
            a, b = cross_p.search_for_end_height(h), cross_r.search_for_end_height(h)
            assert (a is None) == (b is None)
            if a is not None:
                assert [(r.kind, r.data) for r in a] == [(r.kind, r.data) for r in b]
    finally:
        cross_p._group.close()
        cross_r._group.close()


def _stream(tag: int) -> tuple:
    """A record stream and its records' end offsets."""
    recs = [rwal.WALRecord(time_ns=T0 + i, kind=KINDS[i % 4], data=rng(1710 + tag).bytes(9 * i))
            for i in range(8)]
    data, ends = b"", []
    for rec in recs:
        data += rwal.encode_record(rec)
        ends.append(len(data))
    return data, ends


def _decoded(mod, data: bytes, torn: bool) -> tuple:
    got = outcome(lambda: mod.decode_records(data, allow_torn_tail=torn))
    if got != ("ok",):
        return got
    return tuple((r.time_ns, r.kind, r.data) for r in mod.decode_records(data, torn))


CORRUPTIONS = ["crc", "payload", "length", "huge_length", "torn_tail", "torn_header",
               "crc_last"]


@pytest.mark.parametrize("how", CORRUPTIONS)
def test_corrupted_records_are_refused_alike(how):
    data, ends = _stream(0)
    bad = bytearray(data)
    at = ends[3]                     # record 4 starts here
    if how == "crc":
        bad[at] ^= 1
    elif how == "payload":
        bad[at + 9] ^= 0x40
    elif how == "length":
        bad[at + 7] ^= 2
    elif how == "huge_length":
        bad[at + 4:at + 8] = (3 * 1024 * 1024).to_bytes(4, "big")
    elif how == "torn_tail":
        bad = bad[:-5]
    elif how == "torn_header":
        bad = bad[:ends[-1] - (ends[-1] - ends[-2]) + 5]
    elif how == "crc_last":
        bad[ends[-2]] ^= 1
    bad = bytes(bad)
    # the same outcome at every prefix that ends on a record boundary and
    # on the whole stream, torn tail allowed or not
    cuts = [e for e in ends if e <= len(bad)] + [len(bad)]
    for torn in (True, False):
        ref = [_decoded(rwal, bad[:c], torn) for c in cuts]
        assert [_decoded(pwal, bad[:c], torn) for c in cuts] == ref
    whole = _decoded(pwal, bad, False)
    if how in ("crc", "payload", "length", "huge_length"):
        assert whole[0] == "WALCorruptionError"
        assert _decoded(pwal, bad[:at], False)[0] != "WALCorruptionError"
    assert pwal.WALCorruptionError.__mro__[1].__name__ == "WALError"


def test_group_rotates_and_prunes_as_the_reference(tmp_path):
    out = []
    for mod, sub in ((rauto, "ref"), (pauto, "port")):
        path = str(tmp_path / sub / "head")
        g = mod.Group(path, head_size_limit=100, total_size_limit=700)
        steps = []
        for i in range(30):
            g.write(bytes([i]) * (13 + 7 * i % 50))
            steps.append((g.maybe_rotate(), g.head_size(), [os.path.basename(p)
                                                            for p in g.paths()]))
        g.rotate()
        steps.append(g.read_all())
        g.truncate_all()
        g.write(b"after")
        steps.append((g.read_all(), g.paths() == [path]))
        g.close()
        out.append((steps, _files(path)))
    assert out[1] == out[0]
    assert any(rot for rot, _, _ in out[0][0][:30])


def _response(tag: int, mod):
    g = rng(1720 + tag)
    resp = rabci.FinalizeBlockResponse(
        tx_results=tuple(rabci.ExecTxResult(code=int(g.integers(0, 3)), data=g.bytes(5),
                                            gas_used=int(g.integers(0, 100)))
                         for _ in range(int(g.integers(0, 4)))),
        validator_updates=tuple(rabci.ValidatorUpdate("ed25519", g.bytes(32),
                                                      int(g.integers(0, 20)))
                                for _ in range(tag % 3)),
        app_hash=g.bytes(32))
    return resp if mod is rabci else pabci.FinalizeBlockResponse.decode(resp.encode())


def _block_id(tag: int):
    g = rng(1730 + tag)
    h = g.bytes(32)
    return rblock.BlockID(hash=h, part_set_header=rblock.PartSetHeader(
        total=int(g.integers(1, 9)), hash=g.bytes(32)))


def _strip_tail(got: tuple) -> tuple:
    """(class, message) without the flight recorder's tail (its times)."""
    return got if len(got) < 2 else (got[0], got[1].split("\n")[0])


@pytest.mark.parametrize("tag", range(4))
def test_transition_digest_equals_the_reference(tag):
    bid = _block_id(tag)
    ref = rdet.transition_digest(7 + tag, bid, _response(tag, rabci))
    port = pdet.transition_digest(7 + tag, pcodec.decode_block_id(bid.encode()),
                                  _response(tag, pabci))
    assert port.encode() == ref.encode()
    assert pdet.TransitionDigest.decode(ref.encode()) == port
    assert rdet.TransitionDigest.decode(port.encode()).encode() == ref.encode()
    other = rdet.transition_digest(7 + tag, bid, replace(_response(tag, rabci),
                                                         app_hash=b"\x01" * 32))
    pother = pdet.TransitionDigest.decode(other.encode())
    for rec, rep in ((ref, other), (other, ref), (ref, replace(ref, height=ref.height + 1))):
        got = outcome(lambda: pdet.compare(pdet.TransitionDigest.decode(rec.encode()),
                                           pdet.TransitionDigest.decode(rep.encode()),
                                           surface="wal_replay"))
        want = outcome(lambda: rdet.compare(rdet.TransitionDigest.decode(rec.encode()),
                                            rdet.TransitionDigest.decode(rep.encode()),
                                            surface="wal_replay"))
        assert _strip_tail(got) == _strip_tail(want)
        assert got[0] == "DivergenceError"
    assert outcome(lambda: pdet.compare(port, pdet.TransitionDigest.decode(ref.encode()),
                                        surface="startup")) == ("ok",)
    assert pother.fields["app_hash"] != port.fields["app_hash"]


# -- the slice whole: a port validator stopped mid-height, replayed -----------------

CRASH_AT = 3
HEIGHTS = 5


def _ref_side() -> dict:
    """chip_smoke's ``wal_side`` for the reference's package: its modules,
    and a node assembled as ``chip_smoke.cs_node`` assembles the port's
    (MemDB stores, a KVStoreApp through the local proxy, an EventBus, a
    CListMempool, the executor, the Handshaker, ConsensusState over the
    given WAL); the reference reads its determinism guard from
    CMT_TPU_DETERMINISM."""
    from types import SimpleNamespace

    from cometbft_tpu import consensus, privval, proxy
    from cometbft_tpu import state as rstate
    from cometbft_tpu import store as rstore
    from cometbft_tpu.abci.kvstore import KVStoreApp
    from cometbft_tpu.consensus import state as csm
    from cometbft_tpu.crypto import ed25519
    from cometbft_tpu.mempool import CListMempool
    from cometbft_tpu.state.execution import BlockExecutor
    from cometbft_tpu.types import PRECOMMIT_TYPE, PREVOTE_TYPE, BlockID, Vote
    from cometbft_tpu.types import event_bus, genesis, part_set
    from cometbft_tpu.types.vote import Proposal
    from cometbft_tpu.utils import db, log

    m = SimpleNamespace(
        Vote=Vote, Proposal=Proposal, BlockID=BlockID, PREVOTE_TYPE=PREVOTE_TYPE,
        PRECOMMIT_TYPE=PRECOMMIT_TYPE, VoteMessage=consensus.VoteMessage,
        ProposalMessage=consensus.ProposalMessage, BlockPartMessage=consensus.BlockPartMessage,
        EVENT_NEW_ROUND=event_bus.EVENT_NEW_ROUND,
        EVENT_COMPLETE_PROPOSAL=event_bus.EVENT_COMPLETE_PROPOSAL,
        query_for_event=event_bus.query_for_event,
        BLOCK_PART_SIZE_BYTES=part_set.BLOCK_PART_SIZE_BYTES, Ed25519PubKey=ed25519.Ed25519PubKey,
        priv_key_from_secret=ed25519.priv_key_from_secret, FilePV=privval.FilePV, WAL=rwal.WAL,
        KIND_MSG_INFO=rwal.KIND_MSG_INFO, csm=csm, verify_wal_digests=rdet.verify_wal_digests,
        GenesisDoc=genesis.GenesisDoc, GenesisValidator=genesis.GenesisValidator,
        Handshaker=consensus.Handshaker, ConsensusState=consensus.ConsensusState,
        Logger=log.Logger, NopLogger=log.NopLogger)

    def node(gen, pv, config, logger, w):
        n = dict(block_store=rstore.BlockStore(db.MemDB()), state_store=rstate.Store(db.MemDB()),
                 bus=event_bus.EventBus(), services=[])
        n["conns"] = proxy.new_app_conns(proxy.local_client_creator(KVStoreApp(db.MemDB())))
        for svc in (n["conns"], n["bus"]):
            svc.start()
            n["services"].append(svc)
        state = rstate.load_state_from_db_or_genesis(n["state_store"], gen)
        mp = CListMempool(n["conns"].mempool, height=state.last_block_height)
        n["exec"] = BlockExecutor(n["state_store"], n["conns"].consensus, mp,
                                  block_store=n["block_store"], event_bus=n["bus"],
                                  logger=log.NopLogger())
        state = consensus.Handshaker(n["state_store"], state, n["block_store"], gen,
                                     logger=log.NopLogger()).handshake(n["conns"])
        n["cs"] = consensus.ConsensusState(config.consensus, state, n["exec"], n["block_store"],
                                           priv_validator=pv, event_bus=n["bus"], wal=w,
                                           logger=logger)
        n["services"].append(n["cs"])
        return n

    def close(n):
        for svc in reversed(n["services"]):
            if svc.is_running():
                svc.stop()

    return dict(m=m, node=node, close=close, kw={}, hs_kw={})


# the node's receive thread ends by SystemExit (the stop under test), which
# pytest's thread-exception hook reports as a warning
@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_port_validator_stopped_mid_height_commits_the_references_chain(monkeypatch,
                                                                          tmp_path):
    """chip_smoke's (w) at 1 + 3 validators on ``device="cpu"``: the port
    validator (file WAL, determinism on) ends right after the WAL holds
    its own precommit of height 3; a new ConsensusState over the same WAL,
    stores, FilePV (reloaded from its files) and app replays the height
    and commits on.  Its chain -- block ids and app hashes at every
    height -- equals an uninterrupted port run's and the reference's
    uninterrupted run's under the same stub votes; the replay checked a
    transition digest; every digest record in each WAL matches its
    stores; the commit of height 3 holds the precommit the FilePV signed
    before the stop (chip_smoke checks it), and the FilePV refused to sign
    below the step it had reached."""
    import torch

    import chip_smoke
    from cometbft_tpu import config as rconfig
    from cometbft_tpu_torch import config as pconfig

    monkeypatch.setenv("CMT_TPU_DETERMINISM", "1")
    monkeypatch.setenv("CMT_TPU_DISABLE_DEVICE_VERIFY", "1")
    cpu = torch.device("cpu")
    r = chip_smoke.cs_wal_run(cpu, "wal-cpu", 3, HEIGHTS, CRASH_AT, str(tmp_path / "work"),
                              config=pconfig.test_config(), timeout_s=60)
    ref = chip_smoke.cs_wal_chain(cpu, "wal-cpu (reference)", 3, HEIGHTS,
                                  str(tmp_path / "ref"), None, config=rconfig.test_config(),
                                  timeout_s=60, side=_ref_side())
    assert len(ref["chain"]) == HEIGHTS and ref["digests_verified"] == HEIGHTS
    assert r["crash"]["chain"] == r["plain"]["chain"] == ref["chain"]
    assert r["crash"]["replayed_records"] >= 2 and r["crash"]["replayed_digests"] >= 1
    assert r["plain"]["digests_verified"] == HEIGHTS
    assert r["crash"]["refusals"] >= 1 and r["plain"]["refusals"] == 0


@pytest.mark.parametrize("tamper", [None, 5, 17])
def test_handshaker_digest_check_equals_the_reference(monkeypatch, tamper):
    """Each package's Handshaker, determinism guard on, replays the
    execution test's chain (24 applied heights) into a fresh app over a
    copy of its stores: every re-executed block reproduces the stored
    FinalizeBlock response; with the response stored at ``tamper``
    given another app hash, both raise DivergenceError at that height
    with the same message (the flight recorder's tail aside)."""
    from tests.test_torch_statesync import PORT as SPORT, REF as SREF, _stores

    monkeypatch.setenv("CMT_TPU_DETERMINISM", "1")
    monkeypatch.setenv("CMT_TPU_DISABLE_DEVICE_VERIFY", "1")
    out = []
    for side in (SREF, SPORT):
        kw = dict(device="cpu", determinism=True) if side["port"] else {}
        gen, blocks, states = _stores(side)
        if tamper is not None:
            resp = states.load_finalize_block_response(tamper)
            states.save_finalize_block_response(tamper, replace(resp, app_hash=b"\x01" * 32))
        app = side["kv"].KVStoreApp(side["db"].MemDB())
        conns = side["proxy"].new_app_conns(side["proxy"].local_client_creator(app))
        hs = side["consensus"].Handshaker(states, states.load(), blocks, gen,
                                          logger=side["log"].NopLogger(), **kw)
        out.append(_strip_tail(outcome(lambda: hs.handshake(conns))))
        if side["port"]:
            checked = hs.n_digests_checked
    assert out[1] == out[0]
    if tamper is None:
        assert out[0] == ("ok",) and checked == 24
    else:
        assert out[0][0] == "DivergenceError" and f"at height {tamper} (handshake)" in out[0][1]
        assert checked == tamper - 1
