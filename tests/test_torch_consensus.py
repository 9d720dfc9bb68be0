"""The port's consensus (cometbft_tpu_torch/consensus: the ticker, the
messages, the height vote set, the Handshaker, ConsensusState and
ConsensusReactor; privval's FilePV; ConsensusMetrics) against the
reference's (cometbft_tpu/...), which imports no jax for these modules.

The same inputs, made from a seed with numpy, go to both packages:
every consensus message is encoded by each package from its own
objects and decoded by the other; the ticker runs the reference's own
cases; a scripted sequence of prevotes, precommits, catch-up rounds and
peer majorities goes through both height vote sets; FilePV signs one
sequence in both, double-sign refusals included.  The slice whole: two
port validators and two reference validators make one 4-validator
network over 127.0.0.1 TCP (each a switch of its package's
``p2p/test_util.make_switch`` with its package's ConsensusReactor and
MempoolReactor), with the ``test_config`` timeouts; a port node is then
restarted on its stores with a fresh app (the Handshaker replays the
chain into it) and rejoins.  One more run drives one port validator
and three stubs on ``device="cpu"`` with a verify queue installed.
Tolerance: exact -- message bytes, tallies, bit arrays, errors (class
and message), signatures, state JSON, metrics exposition, and every
node's stored block hash at every height.  The reference verifies with
CMT_TPU_DISABLE_DEVICE_VERIFY=1 (its host verifier), the port on
``device="cpu"``.  Every wait is bounded; every node is stopped in a
``finally``."""

import json
import threading
import time

import numpy as np
import pytest

from cometbft_tpu import config as rconfig
from cometbft_tpu import metrics as rmetrics
from cometbft_tpu import privval as rprivval
from cometbft_tpu.consensus import height_vote_set as rhvs
from cometbft_tpu.consensus import messages as rmsg
from cometbft_tpu.consensus import reactor as rreactor
from cometbft_tpu.consensus import ticker as rticker
from cometbft_tpu.crypto import ed25519 as red
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import canonical as rcanon
from cometbft_tpu.types import part_set as rparts
from cometbft_tpu.types import vote as rvote
from cometbft_tpu.utils import bit_array as rbits
from cometbft_tpu.utils import metrics as rumetrics
from cometbft_tpu_torch import config as pconfig
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch import privval as pprivval
from cometbft_tpu_torch.abci.types import InfoRequest as PInfoRequest
from cometbft_tpu_torch.consensus import height_vote_set as phvs
from cometbft_tpu_torch.consensus import messages as pmsg
from cometbft_tpu_torch.consensus import reactor as preactor
from cometbft_tpu_torch.consensus import ticker as pticker
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.crypto import verify_queue as vq
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import part_set as pparts
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.utils import bit_array as pbits
from cometbft_tpu_torch.utils import metrics as pumetrics
from tests.test_torch_types import outcome, port_val_set, ref_val_set, rng
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

CHAIN = "cs-parity"
T0 = 1_700_000_000_000_000_000
WAIT = 120.0        # every network wait's bound (the runs take seconds)


# -- the messages ----------------------------------------------------------------

def _bits(mod, n: int, on) -> object:
    ba = mod.BitArray(n)
    for i in on:
        ba.set_index(i, True)
    return ba


def _message_values(g) -> dict:
    """Raw values of one message of each kind, drawn from ``g``."""
    return dict(
        h=int(g.integers(1, 1 << 40)), r=int(g.integers(0, 50)), step=int(g.integers(1, 9)),
        bh=g.bytes(32), ph=g.bytes(32), total=3, data=g.bytes(3 * 64 + 17),
        on=sorted(int(x) for x in g.choice(150, 37, replace=False)), sig=g.bytes(64),
        addr=g.bytes(20), ts=T0 + int(g.integers(0, 10**12)), idx=int(g.integers(0, 150)),
        pol=int(g.integers(-1, 3)), secs=int(g.integers(0, 1000)),
    )


def _messages(side, v) -> list:
    """One message of each kind (and variants), built from ``side``'s own
    objects: (block, parts, vote, bit array, message) modules."""
    blk, parts, vote, bits, msg = side
    psh = blk.PartSetHeader(total=v["total"], hash=v["ph"])
    bid = blk.BlockID(hash=v["bh"], part_set_header=psh)
    ps = parts.PartSet.from_bytes(v["data"], 64)
    prop = vote.Proposal(height=v["h"], round=v["r"] + 2, pol_round=v["pol"], block_id=bid,
                         timestamp_ns=v["ts"], signature=v["sig"])
    vt = vote.Vote(type=rcanon.PRECOMMIT_TYPE, height=v["h"], round=v["r"], block_id=bid,
                   timestamp_ns=v["ts"], validator_address=v["addr"],
                   validator_index=v["idx"], signature=v["sig"])
    nil = vote.Vote(type=rcanon.PREVOTE_TYPE, height=v["h"], round=v["r"],
                    block_id=blk.BlockID(), timestamp_ns=v["ts"],
                    validator_address=v["addr"], validator_index=0, signature=v["sig"])
    return [
        msg.NewRoundStepMessage(v["h"], v["r"], v["step"], v["secs"], v["r"] - 1),
        msg.NewRoundStepMessage(1, 0, 1),
        msg.NewValidBlockMessage(v["h"], v["r"], psh, _bits(bits, 3, [0, 2]), True),
        msg.NewValidBlockMessage(v["h"], v["r"], psh, _bits(bits, 3, [])),
        msg.ProposalMessage(prop),
        msg.ProposalPOLMessage(v["h"], v["r"], _bits(bits, 150, v["on"])),
        msg.BlockPartMessage(v["h"], v["r"], ps.get_part(1)),
        msg.BlockPartMessage(v["h"], v["r"], ps.get_part(3)),
        msg.VoteMessage(vt),
        msg.VoteMessage(nil),
        msg.HasVoteMessage(v["h"], v["r"], rcanon.PREVOTE_TYPE, v["idx"]),
        msg.VoteSetMaj23Message(v["h"], v["r"], rcanon.PRECOMMIT_TYPE, bid),
        msg.VoteSetBitsMessage(v["h"], v["r"], rcanon.PREVOTE_TYPE, bid,
                               _bits(bits, 150, v["on"])),
        msg.VoteSetBitsMessage(v["h"], v["r"], rcanon.PRECOMMIT_TYPE, blk.BlockID(),
                               _bits(bits, 0, [])),
    ]


REF_SIDE = (rblock, rparts, rvote, rbits, rmsg)
PORT_SIDE = (pblock, pparts, pvote, pbits, pmsg)


@pytest.mark.parametrize("seed", range(4))
def test_messages_encode_alike_and_decode_both_ways(seed):
    v = _message_values(rng(seed))
    ref, port = _messages(REF_SIDE, v), _messages(PORT_SIDE, v)
    for rm, pm in zip(ref, port):
        raw = rmsg.encode_message(rm)
        assert pmsg.encode_message(pm) == raw, type(rm).__name__
        assert pmsg.encode_message(pmsg.decode_message(raw)) == raw
        assert rmsg.encode_message(rmsg.decode_message(pmsg.encode_message(pm))) == raw
        assert type(pmsg.decode_message(raw)).__name__ == type(rm).__name__


def test_trace_context_rides_both_ways():
    v = _message_values(rng(11))
    rctx = rmsg.TraceContext(origin="ab" * 20, height=v["h"], round=v["r"], send_wall=1.7e9 + 0.25)
    pctx = pmsg.TraceContext(origin="ab" * 20, height=v["h"], round=v["r"], send_wall=1.7e9 + 0.25)
    for rm, pm in zip(_messages(REF_SIDE, v), _messages(PORT_SIDE, v)):
        raw = rmsg.encode_message(rm, rctx)
        assert pmsg.encode_message(pm, pctx) == raw
        got, ctx = pmsg.decode_message_traced(raw)
        _, want = rmsg.decode_message_traced(raw)
        assert pmsg.encode_message(got) == rmsg.encode_message(rm)
        assert (ctx.origin, ctx.height, ctx.round, ctx.send_wall) == \
            (want.origin, want.height, want.round, want.send_wall)
    assert pmsg.stamping_enabled() is rmsg.stamping_enabled() is True


MALFORMED = [b"", b"\x0a", b"\x0a\x00\x12\x00", b"\x12\x02\x08\x01", b"\x1a\x03\x0a\x01\x00",
             b"\x22\x04\x08\x01\x1a\x00", b"\x52\x00", b"\x7a\x00",
             b"\x7a\x00\x7a\x00\x0a\x00", b"\x0a\x00\x7a\x02\x08\xff", b"\xff\xff\xff",
             b"\x22\x08\x08\x01\x10\x02\x1a\x02\x08\x7f", b"\x4a\x07\x08\x01\x10\x02\x18\x01",
             b"\x32\x00", b"\x2a\x06\x08\x01\x10\x00\x1a\x00"]


@pytest.mark.parametrize("raw", MALFORMED)
def test_malformed_messages_are_refused_alike(raw):
    def dec(mod):
        return lambda: mod.encode_message(mod.decode_message_traced(raw)[0])

    assert outcome(dec(pmsg)) == outcome(dec(rmsg))


# -- the ticker (the reference's own cases, in both packages) ------------------------

def _fired(mod, schedule, wait: float):
    fired = []
    t = mod.TimeoutTicker(fired.append)
    t.start()
    try:
        for ti in schedule:
            t.schedule(mod.TimeoutInfo(*ti))
        deadline = time.time() + wait
        while not fired and time.time() < deadline:
            time.sleep(0.005)
        time.sleep(0.05)
    finally:
        t.stop()
    return [f.hrs() for f in fired]


@pytest.mark.parametrize("case,schedule", [
    ("fires", [(10 * 10**6, 1, 0, 3)]),
    ("newer replaces", [(50 * 10**6, 1, 0, 3), (10 * 10**6, 1, 1, 3)]),
    ("stale ignored", [(30 * 10**6, 5, 2, 3), (1 * 10**6, 4, 0, 3)]),
])
def test_ticker_as_the_reference(case, schedule):
    assert _fired(pticker, schedule, 2.0) == _fired(rticker, schedule, 2.0)
    assert pticker.STEP_NAMES == rticker.STEP_NAMES


# -- the height vote set ------------------------------------------------------------

def _vote(mod, key, idx, vtype, height, round_, bid, ts):
    v = mod.Vote(type=vtype, height=height, round=round_, block_id=bid, timestamp_ns=ts,
                 validator_address=key.pub_key().address(), validator_index=idx)
    from dataclasses import replace

    return replace(v, signature=key.sign(v.sign_bytes(CHAIN)))


def _hvs_summary(hvs, rounds) -> list:
    out = [hvs.round(), hvs.pol_info()[0]]
    pol = hvs.pol_info()[1]
    out.append(pol.encode() if pol is not None else None)
    for r in rounds:
        for vs in (hvs.prevotes(r), hvs.precommits(r)):
            if vs is None:
                out.append(None)
                continue
            maj = vs.two_thirds_majority()
            out.append((maj.encode() if maj is not None else None, vs.bit_array().to_bytes(),
                        vs.sum_voting_power(), vs.has_two_thirds_any(), vs.has_all()))
    return out


def _hvs_script(side, keys, vals, g):
    """The scripted sequence through ``side``'s HeightVoteSet -> the
    outcome and summary after every step."""
    blk, hvs_mod, vote_mod = side
    bid_a = blk.BlockID(hash=g.bytes(32), part_set_header=blk.PartSetHeader(1, g.bytes(32)))
    bid_b = blk.BlockID(hash=g.bytes(32), part_set_header=blk.PartSetHeader(2, g.bytes(32)))
    nil = blk.BlockID()
    hvs = hvs_mod.HeightVoteSet(CHAIN, 7, vals)
    PV, PC = rcanon.PREVOTE_TYPE, rcanon.PRECOMMIT_TYPE
    steps = []
    for i in range(3):
        steps.append(("vote", PV, i, 0, bid_a, ""))
    steps.append(("vote", PV, 3, 0, nil, ""))
    steps.append(("vote", PV, 0, 0, bid_a, ""))                 # a duplicate
    steps.append(("vote", PC, 0, 0, bid_a, ""))
    steps.append(("vote", PC, 1, 0, nil, ""))
    steps.append(("round", 1))
    steps.append(("vote", PV, 0, 1, bid_b, ""))
    steps.append(("vote", PV, 1, 1, nil, ""))
    steps.append(("vote", PV, 2, 5, bid_b, "p1"))               # catch-up rounds
    steps.append(("vote", PV, 3, 6, bid_b, "p1"))
    steps.append(("vote", PC, 3, 9, bid_b, "p1"))               # a third: refused
    steps.append(("vote", PC, 2, 9, bid_b, "p2"))
    steps.append(("vote", PV, 0, 0, bid_b, ""))                 # conflicting
    steps.append(("maj23", 0, PV, "p3", bid_b))
    steps.append(("vote", PV, 0, 0, bid_b, ""))                 # now admitted for bid_b
    steps.append(("maj23", 0, 9, "p3", bid_b))                  # a bad type
    steps.append(("vote", 9, 0, 0, bid_b, ""))
    steps.append(("round", 3))
    for i in range(4):
        steps.append(("vote", PC, i, 3, bid_a, ""))
    out = []
    for st in steps:
        if st[0] == "vote":
            _, vt, i, r, bid, peer = st
            ts = T0 + 1000 * len(out)
            v = _vote(vote_mod, keys[i], i, vt, 7, r, bid, ts)
            res = outcome(lambda: out.append(("added", hvs.add_vote(v, peer))))
        elif st[0] == "round":
            res = outcome(lambda: hvs.set_round(st[1]))
        else:
            _, r, vt, peer, bid = st
            res = outcome(lambda: hvs.set_peer_maj23(r, vt, peer, bid))
        out.append((st[0], res, _hvs_summary(hvs, range(0, 10))))
    return out


def test_height_vote_set_follows_the_reference():
    g = rng(20)
    keys = [red.priv_key_from_secret(g.bytes(32)) for _ in range(4)]
    rvals, keys = ref_val_set(keys)
    pkeys = [ped.Ed25519PrivKey(k.bytes()) for k in keys]
    ref = _hvs_script((rblock, rhvs, rvote), keys, rvals, rng(21))
    port = _hvs_script((pblock, phvs, pvote), pkeys, port_val_set(rvals), rng(21))
    assert port == ref
    assert any(r[1][0] == "HeightVoteSetError" for r in ref if len(r) == 3)
    assert any(r[1][0] == "ConflictingVoteError" for r in ref if len(r) == 3)


# -- FilePV ---------------------------------------------------------------------------

def _pv_script(mod, vote_mod, blk, secret: bytes, key_path, state_path, g):
    """A signing sequence through ``mod``'s FilePV -> outcomes,
    signatures and the state file after each step."""
    ed = red if mod is rprivval else ped
    pv = mod.FilePV(ed.priv_key_from_secret(secret), str(key_path), str(state_path))
    pv.save()
    bid = blk.BlockID(hash=g.bytes(32), part_set_header=blk.PartSetHeader(1, g.bytes(32)))
    other = blk.BlockID(hash=g.bytes(32), part_set_header=blk.PartSetHeader(1, g.bytes(32)))
    addr = pv.address
    PV, PC = rcanon.PREVOTE_TYPE, rcanon.PRECOMMIT_TYPE

    def vote(vt, h, r, b, ts):
        return vote_mod.Vote(type=vt, height=h, round=r, block_id=b, timestamp_ns=ts,
                             validator_address=addr, validator_index=0)

    def prop(h, r, b, ts):
        return vote_mod.Proposal(height=h, round=r, pol_round=-1, block_id=b, timestamp_ns=ts)

    steps = [
        ("proposal", prop(1, 0, bid, T0)),
        ("vote", vote(PV, 1, 0, bid, T0 + 1)),
        ("vote", vote(PV, 1, 0, bid, T0 + 1)),          # the same: the same signature
        ("vote", vote(PV, 1, 0, bid, T0 + 99)),         # only the timestamp differs
        ("vote", vote(PV, 1, 0, other, T0 + 1)),        # conflicting
        ("vote", vote(PC, 1, 0, bid, T0 + 2)),
        ("vote", vote(PV, 1, 0, bid, T0 + 3)),          # step regression
        ("proposal", prop(1, 0, other, T0)),            # step regression
        ("vote", vote(PV, 2, 1, blk.BlockID(), T0 + 4)),
        ("vote", vote(PV, 2, 0, bid, T0 + 5)),          # round regression
        ("vote", vote(PV, 1, 5, bid, T0 + 6)),          # height regression
        ("proposal", prop(3, 0, bid, T0 + 7)),
        ("proposal", prop(3, 0, bid, T0 + 7)),          # the same again
        ("proposal", prop(3, 0, other, T0 + 7)),        # conflicting proposal
        ("vote", vote(PC, 3, 0, bid, T0 + 8)),
    ]
    out = []
    for kind, obj in steps:
        got = []
        fn = pv.sign_proposal if kind == "proposal" else pv.sign_vote
        res = outcome(lambda: got.append(fn(CHAIN, obj)))
        signed = got[0] if got else None
        out.append((kind, res, signed.signature if signed else None,
                    getattr(signed, "timestamp_ns", None), state_path.read_text()))
    loaded = mod.FilePV.load(str(key_path), str(state_path))
    out.append((loaded.height, loaded.round, loaded.step, loaded.signature, loaded.sign_bytes,
                key_path.read_text()))
    return out


def test_file_pv_signs_and_refuses_as_the_reference(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    ref = _pv_script(rprivval, rvote, rblock, b"fpv", tmp_path / "r" / "key.json",
                     tmp_path / "r" / "state.json", rng(30))
    port = _pv_script(pprivval, pvote, pblock, b"fpv", tmp_path / "p" / "key.json",
                      tmp_path / "p" / "state.json", rng(30))
    assert port == ref
    refusals = [r[1] for r in ref if len(r) == 5 and r[1][0] != "ok"]
    assert len(refusals) == 6 and {r[0] for r in refusals} == {"DoubleSignError"}
    assert json.loads(port[-1][-1])["priv_key"]["type"] == "tendermint/PrivKeyEd25519"


def test_file_pv_load_or_generate_round_trips(tmp_path):
    kp, sp = str(tmp_path / "k.json"), str(tmp_path / "s.json")
    pv = pprivval.FilePV.load_or_generate(kp, sp)
    again = pprivval.FilePV.load_or_generate(kp, sp)
    assert again.address == pv.address
    ref = rprivval.FilePV.load(kp, sp)
    assert ref.pub_key.bytes() == pv.pub_key.bytes()


# -- config and metrics -----------------------------------------------------------------

def test_config_sections_equal_the_reference():
    rc, pc = rconfig.test_config(), pconfig.test_config()
    assert vars(pc.consensus) == vars(rc.consensus)
    assert vars(pc.mempool) == vars(rc.mempool)
    assert vars(pconfig.ConsensusConfig()) == vars(rconfig.ConsensusConfig())
    assert vars(pconfig.MempoolConfig()) == vars(rconfig.MempoolConfig())
    for r in range(4):
        for f in ("propose_timeout_ns", "prevote_timeout_ns", "precommit_timeout_ns"):
            assert getattr(pc.consensus, f)(r) == getattr(rc.consensus, f)(r)
    for s in ["1.5s", "500ms", "1m30s", "0", "", "2h3m4s5ms6us7ns", 42, "1x", "s1", "1s "]:
        assert outcome(lambda: pconfig.parse_duration_ns(s)) == \
            outcome(lambda: rconfig.parse_duration_ns(s))
        if outcome(lambda: rconfig.parse_duration_ns(s)) == ("ok",):
            assert pconfig.parse_duration_ns(s) == rconfig.parse_duration_ns(s)


def _drive_consensus_metrics(m) -> None:
    m.height.set(12)
    m.rounds.set(2)
    m.validators.set(4)
    m.validators_power.set(40)
    m.num_txs.set(3)
    m.total_txs.inc(3)
    m.block_size_bytes.set(1234)
    m.block_interval_seconds.observe(1.5)
    m.committed_height.set(11)
    m.block_parts.labels(peer_id="abcd").inc()
    m.quorum_prevote_delay.labels(proposer_address="ff00").set(0.25)
    for step, s in (("Propose", 0.01), ("Prevote", 0.2), ("Commit", 1.1)):
        m.step_duration_seconds.labels(step=step).observe(s)
    m.replay_divergence_total.labels(surface="handshake").inc()
    m.trust_guard_trips_total.labels(sink="apply_block").inc()


def test_consensus_metrics_exposition_equals_the_reference():
    rreg, preg = rumetrics.Registry(), pumetrics.Registry()
    _drive_consensus_metrics(rmetrics.ConsensusMetrics(rreg))
    _drive_consensus_metrics(pmetrics.ConsensusMetrics(preg))
    assert preg.expose() == rreg.expose()
    _drive_consensus_metrics(pmetrics.ConsensusMetrics())      # the no-op struct


# -- vote_from_commit and PeerState ----------------------------------------------------

def test_vote_from_commit_equals_the_reference():
    from tests.test_torch_types import ref_commit

    g = rng(40)
    keys = [red.priv_key_from_secret(g.bytes(32)) for _ in range(5)]
    bid = rblock.BlockID(hash=g.bytes(32), part_set_header=rblock.PartSetHeader(1, g.bytes(32)))
    commit = ref_commit(keys, bid, 9, g, round_=2, signers=[0, 2, 3], chain_id=CHAIN)
    from cometbft_tpu.types import codec as rcodec
    from cometbft_tpu_torch.types import codec as pcodec

    pcommit = pcodec.decode_commit(rcodec.encode_commit(commit))
    for i in range(7):
        r, p = rreactor.vote_from_commit(commit, i), preactor.vote_from_commit(pcommit, i)
        assert (None if p is None else p.encode()) == (None if r is None else r.encode())


def _peer_state_script(mod, bits, msg, g):
    ps = mod.PeerState("peer")
    psh = (rblock if mod is rreactor else pblock).PartSetHeader(4, g.bytes(32))
    out = []
    steps = [
        lambda: ps.apply_new_round_step(msg.NewRoundStepMessage(5, 0, 3, 2, -1)),
        lambda: ps.ensure_vote_bit_arrays(5, 7),
        lambda: ps.apply_has_vote(msg.HasVoteMessage(5, 0, rcanon.PREVOTE_TYPE, 3)),
        lambda: ps.apply_has_vote(msg.HasVoteMessage(5, 0, rcanon.PRECOMMIT_TYPE, 6)),
        lambda: ps.apply_new_valid_block(msg.NewValidBlockMessage(5, 0, psh, _bits(bits, 4, [1]))),
        lambda: ps.set_has_proposal_block_part(5, 0, 2),
        lambda: ps.ensure_catchup_commit_round(5, 1, 7),
        lambda: ps.apply_vote_set_bits(
            msg.VoteSetBitsMessage(5, 0, rcanon.PREVOTE_TYPE, None, _bits(bits, 7, [0, 5])),
            _bits(bits, 7, [0, 1, 2])),
        lambda: ps.apply_new_round_step(msg.NewRoundStepMessage(5, 1, 4, 0, -1)),
        lambda: ps.apply_new_round_step(msg.NewRoundStepMessage(6, 0, 1, 0, 1)),
        lambda: ps.apply_proposal_pol(msg.ProposalPOLMessage(6, -1, _bits(bits, 7, [4]))),
        lambda: ps.apply_new_round_step(msg.NewRoundStepMessage(9, 0, 1, 0, 0)),
    ]
    for step in steps:
        res = outcome(step)
        prs = ps.snapshot()
        row = [res]
        for k, val in sorted(vars(prs).items()):
            if k == "start_time_ns":
                continue
            if hasattr(val, "to_bytes") and hasattr(val, "size"):
                val = (val.size, val.to_bytes())
            elif hasattr(val, "encode"):
                val = val.encode()
            row.append((k, val))
        out.append(row)
    return out


def test_peer_state_follows_the_reference():
    ref = _peer_state_script(rreactor, rbits, rmsg, rng(41))
    port = _peer_state_script(preactor, pbits, pmsg, rng(41))
    assert port == ref


# -- the slice whole: nodes of both packages in one network -----------------------------

def _pkg(name: str) -> dict:
    import importlib

    def m(path):
        return importlib.import_module(f"{name}.{path}")

    return dict(
        port=name.endswith("_torch"), kv=m("abci.kvstore"), proxy=m("proxy"), state=m("state"),
        store=m("store"), db=m("utils.db"), bus=m("types.event_bus"), genesis=m("types.genesis"),
        mempool=m("mempool"), mreactor=m("mempool.reactor"), execution=m("state.execution"),
        consensus=m("consensus"), creactor=m("consensus.reactor"), privval=m("privval"),
        ed=m("crypto.ed25519"), config=m("config"), util=m("p2p.test_util"), log=m("utils.log"),
        ingest=m("mempool.ingest"),
    )


REF, PORT = _pkg("cometbft_tpu"), _pkg("cometbft_tpu_torch")


def make_node(side: dict, secret: bytes, gen_json: str, dbs: dict | None = None) -> dict:
    """One validator of ``side``'s package as the reference's Node
    assembles it (stores over ``dbs``' MemDBs, a KVStoreApp over
    ``dbs["a"]``, the local proxy, an EventBus, CListMempool, the
    executor, the Handshaker, ConsensusState, a ConsensusReactor waiting
    for ``switch_to_consensus`` and a MempoolReactor on a switch of
    ``make_switch``), with the ``test_config`` consensus timeouts."""
    kw = dict(device="cpu") if side["port"] else {}
    gen = side["genesis"].GenesisDoc.from_json(gen_json)
    nop = side["log"].NopLogger()
    pv = side["privval"].FilePV(side["ed"].priv_key_from_secret(secret))
    dbs = dbs or dict(b=side["db"].MemDB(), s=side["db"].MemDB(), a=side["db"].MemDB())
    n = dict(side=side, pv=pv, dbs=dbs, services=[])
    n["blocks"], n["states"] = side["store"].BlockStore(dbs["b"]), side["state"].Store(dbs["s"])
    state = side["state"].load_state_from_db_or_genesis(n["states"], gen)
    n["app"] = side["kv"].KVStoreApp(dbs["a"])
    n["conns"] = side["proxy"].new_app_conns(side["proxy"].local_client_creator(n["app"]))
    n["bus"] = side["bus"].EventBus()
    n["bus"].start()
    n["services"].append(n["bus"])
    n["mempool"] = side["mempool"].CListMempool(n["conns"].mempool,
                                                height=state.last_block_height, **kw)
    n["exec"] = side["execution"].BlockExecutor(n["states"], n["conns"].consensus, n["mempool"],
                                                block_store=n["blocks"], event_bus=n["bus"],
                                                logger=nop, **kw)
    n["hs"] = side["consensus"].Handshaker(n["states"], state, n["blocks"], gen, logger=nop, **kw)
    n["state"] = n["hs"].handshake(n["conns"])
    cfg = side["config"].test_config()
    n["cs"] = side["consensus"].ConsensusState(cfg.consensus, n["state"], n["exec"], n["blocks"],
                                               priv_validator=pv, event_bus=n["bus"],
                                               logger=nop, **kw)
    n["services"].append(n["cs"])
    n["cr"] = side["creactor"].ConsensusReactor(n["cs"], wait_sync=True, logger=nop)
    n["mr"] = side["mreactor"].MempoolReactor(n["mempool"], logger=nop)
    n["sw"] = side["util"].make_switch(network=gen.chain_id,
                                       reactors={"CONSENSUS": n["cr"], "MEMPOOL": n["mr"]})
    n["sw"].start()
    n["services"].append(n["sw"])
    return n


def stop_node(n: dict) -> None:
    for svc in reversed(n["services"]):
        if svc.is_running():
            svc.stop()
    n["services"] = []


def join(nodes: list, new: list) -> None:
    """Dial every node of ``new`` to every other node; wait until each
    of them sees all the others."""
    for a in new:
        for b in nodes:
            if b is not a and not (b in new and nodes.index(b) < nodes.index(a)):
                a["sw"].dial_peer_with_address(b["sw"].transport.listen_addr)
    deadline = time.monotonic() + 30
    while any(n["sw"].peers.size() < len(nodes) - 1 for n in nodes):
        assert time.monotonic() < deadline, [n["sw"].peers.size() for n in nodes]
        time.sleep(0.01)


def wait_heights(nodes: list, h: int) -> None:
    deadline = time.monotonic() + WAIT
    while min(n["cs"].state.last_block_height for n in nodes) < h:
        assert time.monotonic() < deadline, [n["blocks"].height() for n in nodes]
        time.sleep(0.02)


def network_genesis(secrets: list[bytes]) -> str:
    G = REF["genesis"]
    return G.GenesisDoc(chain_id=CHAIN, genesis_time_ns=T0, validators=tuple(
        G.GenesisValidator(red.priv_key_from_secret(s).pub_key(), 10) for s in secrets)).to_json()


def test_port_and_reference_validators_commit_one_chain():
    """Two port and two reference validators over TCP commit the same
    blocks; a port node restarts with a fresh app through the Handshaker
    and rejoins; txs of both kinds, sent to a node of each package, are
    committed once."""
    secrets = [b"mixnet-%d" % i for i in range(4)]
    sides = [PORT, REF, PORT, REF]
    gen_json = network_genesis(secrets)
    nodes = []
    signed = PORT["ingest"].make_signed_tx(ped.priv_key_from_secret(b"sender"), b"signed=tx")
    try:
        for side, secret in zip(sides, secrets):
            nodes.append(make_node(side, secret, gen_json))
        join(nodes, nodes)
        for n in nodes:
            n["cr"].switch_to_consensus(n["state"])
        nodes[1]["mempool"].check_tx(b"plain=tx")
        nodes[0]["mempool"].check_tx(signed)
        wait_heights(nodes, 3)
        # restart port node 0 on its stores with a fresh app
        stop_node(nodes[0])
        top = nodes[0]["cs"].state.last_block_height
        dbs = dict(nodes[0]["dbs"], a=PORT["db"].MemDB())
        nodes[0] = make_node(PORT, secrets[0], gen_json, dbs)
        restarted = nodes[0]
        assert restarted["hs"].n_blocks_replayed >= top
        assert restarted["state"].app_hash == \
            restarted["app"].info(PInfoRequest()).last_block_app_hash
        join(nodes, [restarted])
        restarted["cr"].switch_to_consensus(restarted["state"])
        wait_heights(nodes, max(top + 1, 4))
    finally:
        for n in nodes:
            stop_node(n)
    h = min(n["blocks"].height() for n in nodes)
    assert h >= 4
    for k in range(1, h + 1):
        assert len({n["blocks"].load_block_meta(k).block_id.hash for n in nodes}) == 1, k
    txs = [tx for k in range(1, h + 1) for tx in nodes[1]["blocks"].load_block(k).data.txs]
    assert sorted(txs) == sorted([b"plain=tx", signed])
    sigs = [s for k in range(1, h) for s in nodes[2]["blocks"].load_block_commit(k).signatures
            if not s.is_absent()]
    assert len(sigs) >= 3 * (h - 1)
    _handshake_both(nodes[2]["dbs"], gen_json)


def _handshake_both(dbs: dict, gen_json: str) -> None:
    """The Handshaker of each package on a copy of one node's stores with
    a fresh app: the same replay count, state bytes and app hash."""
    from cometbft_tpu import state as rstate

    out = []
    for side in (REF, PORT):
        kw = dict(device="cpu") if side["port"] else {}
        copy = {k: side["db"].MemDB() for k in ("b", "s")}
        for k in ("b", "s"):
            for key, val in dbs[k].iterator():
                copy[k].set(bytes(key), bytes(val))
        gen = side["genesis"].GenesisDoc.from_json(gen_json)
        states = side["state"].Store(copy["s"])
        state = side["state"].load_state_from_db_or_genesis(states, gen)
        app = side["kv"].KVStoreApp(side["db"].MemDB())
        conns = side["proxy"].new_app_conns(side["proxy"].local_client_creator(app))
        hs = side["consensus"].Handshaker(states, state, side["store"].BlockStore(copy["b"]), gen,
                                          logger=side["log"].NopLogger(), **kw)
        got = hs.handshake(conns)
        out.append((hs.n_blocks_replayed, rstate.encode_state(
            rstate.decode_state(side["state"].encode_state(got))), got.app_hash))
    assert out[0] == out[1] and out[0][0] >= 3


def test_one_node_and_three_stubs_commit_with_a_queue_on_the_cpu():
    """chip_smoke's commit-N-consensus run at 1 + 3 validators on
    ``device="cpu"`` with a verify queue installed (the host tier): every
    commit carries at least 3 signatures, the queue takes every vote and
    the LastCommit checks hit its speculative cache."""
    import chip_smoke
    from cometbft_tpu_torch.crypto.batch import create_batch_verifier

    registry = pumetrics.Registry()
    saved = pmetrics._CRYPTO
    pmetrics.install_crypto_metrics(pmetrics.CryptoMetrics(registry))
    try:
        r = chip_smoke.cs_stub_run(
            torch_cpu(), "stubs", registry, 3, 4, True, config=pconfig.test_config(),
            verifier_factory=lambda pk: create_batch_verifier(pk, device="cpu"),
            timeout_s=WAIT)
    finally:
        pmetrics.install_crypto_metrics(saved)
    assert [row["height"] for row in r["per_height"]] == [1, 2, 3, 4]
    assert all(row["sigs"] >= 3 for row in r["per_height"])
    assert r["stats"]["submitted"]["consensus"] >= 4 * 3 * 2
    assert r["stats"]["failed_batches"] == 0
    assert r["hits"] >= 3 * 3 and r["launches"] == {}
    assert vq._QUEUE is None


def test_the_smoke_localnet_dials_a_dropped_node_again():
    """chip_smoke's localnet mesh (``cs_mesh``) dials every pair
    persistent, as ``p2p.persistent_peers`` does: when every peer drops
    node 0, as three pong timeouts did on the card, node 0 dials each of
    them again and the mesh is whole with new connections."""
    import chip_smoke
    from cometbft_tpu_torch.p2p.test_util import make_switch

    ns = [{"sw": make_switch(moniker=f"mesh{i}")} for i in range(3)]
    try:
        for n in ns:
            n["sw"].start()
        first = chip_smoke.cs_mesh(ns, timeout=WAIT)
        node0 = ns[0]["sw"].node_info().node_id
        for n in ns[1:]:
            for p in n["sw"].peers.copy():
                if p.id == node0:
                    n["sw"].stop_peer_for_error(p, "pong timeout")
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            now = [n["sw"].peers.copy() for n in ns]
            if all(len(p) == 2 for p in now) and not set(now[0]) & set(first[0]):
                break
            time.sleep(0.02)
        assert [len(p) for p in now] == [2, 2, 2]
        assert not set(now[0]) & set(first[0])
        assert {p.id for p in now[0]} == {p.id for p in first[0]}
    finally:
        for n in ns:
            n["sw"].stop()


def torch_cpu():
    import torch

    return torch.device("cpu")


def test_a_block_part_of_another_round_is_dropped():
    """A part that fails its proof against the round's part set: the
    reference raises whatever its round (its receive routine logs it as
    an error); the port drops one of another round, as CometBFT's
    handleMsg does, and raises for one of its own round."""
    from cometbft_tpu.consensus import MsgInfo as RMsgInfo
    from cometbft_tpu_torch.consensus import MsgInfo as PMsgInfo

    out = {}
    for side in (REF, PORT):
        n = make_node(side, b"parts", network_genesis([b"parts"]))
        try:
            cs = n["cs"]
            mod = pparts if side["port"] else rparts
            mine = mod.PartSet.from_bytes(rng(50).bytes(300), 64)
            other = mod.PartSet.from_bytes(rng(51).bytes(300), 64)
            cs.proposal_block_parts = mod.PartSet(mine.header)
            msg_mod = pmsg if side["port"] else rmsg
            info = PMsgInfo if side["port"] else RMsgInfo
            res = []
            for r in (cs.round + 1, cs.round):
                part = msg_mod.BlockPartMessage(cs.height, r, other.get_part(0))
                res.append(outcome(lambda: cs._handle_msg(info(part, "peer"))))
            out[side["port"]] = res
        finally:
            stop_node(n)
    assert out[False] == [("PartSetError", "invalid part proof")] * 2
    assert out[True] == [("ok",), ("PartSetError", "invalid part proof")]
