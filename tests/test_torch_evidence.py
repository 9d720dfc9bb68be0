"""The port's evidence plane (cometbft_tpu_torch/evidence: the pool and
its reactor; consensus/byz.py; EvidenceMetrics) against the reference's
(cometbft_tpu/...), which imports no jax for these modules.

The same inputs go to both packages: a chain of 4 validators built
from seeded keys (tests/test_torch_store.py ``chain``), saved into each
package's stores; evidence built with the reference's types and carried
into the port by its wire bytes.  Each case of the pool's ``verify`` --
a valid duplicate vote and each of its refusals, a valid lunatic, a
forward-lunatic and an equivocation attack and each attack refusal,
evidence expired by blocks and by time -- gives the same outcome in
both (``ok``, or the exception's class and message); the pending ->
committed -> pruned lifecycle leaves the same DB image, pending list and
metrics after every step; the evidence-list codec and the adversary's
hooks give the same bytes; a port proposer armed to forge gives the
reference's forged block, which every honest executor refuses; the
evidence reactor keeps, stops or raises by the error's class.  The
slice whole: two port and two reference validators over 127.0.0.1 TCP,
one reference validator armed to equivocate as the reference arms it,
or one port validator armed through its executor (with a second port
validator corrupting the parts it gossips); the evidence is committed
and all four stores hold the same blocks; a fresh port node then
blocksyncs past the block that carries it.  Tolerance: exact.  The reference
verifies with CMT_TPU_DISABLE_DEVICE_VERIFY=1 (its host verifier), the
port on ``device="cpu"``.  Every wait is bounded; every node is stopped
in a ``finally``."""

import threading
import time
from dataclasses import replace

import pytest

from cometbft_tpu import metrics as rmetrics
from cometbft_tpu.consensus import byz as rbyz
from cometbft_tpu.consensus import reactor as rcreactor
from cometbft_tpu.crypto import ed25519 as red
from cometbft_tpu.evidence import pool as rpool
from cometbft_tpu.evidence import reactor as rreactor
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import canonical as rcanon
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types import evidence as rev
from cometbft_tpu.types import light_block as rlb
from cometbft_tpu.types import part_set as rparts
from cometbft_tpu.types import validator as rvalidator
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import metrics as rumetrics
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch.consensus import byz as pbyz
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.evidence import pool as ppool
from cometbft_tpu_torch.evidence import reactor as preactor
from cometbft_tpu_torch.p2p.base_reactor import Envelope
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.types import evidence as pev
from cometbft_tpu_torch.types import part_set as pparts
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import metrics as pumetrics
from tests.test_torch_store import BLOCK_NS, chain, fill, image, port_state
from tests.test_torch_types import CHAIN, outcome, ref_keys, rng, signed_precommit
from tests.test_torch_validation import clean  # noqa: F401 -- autouse fixture

SHAPE = dict(heights=6, nval=4, every=3, keep=1, tag=16)
TOP = SHAPE["heights"]
FIXED_NOW = 1_800_000_000_000_000_000


def _bid(tag: bytes) -> rblock.BlockID:
    h = (tag * 32)[:32]
    return rblock.BlockID(hash=h, part_set_header=rblock.PartSetHeader(total=1, hash=h[::-1]))


def _pools(r, p) -> tuple:
    return (rpool.Pool(rdb.MemDB(), r["states"], r["blocks"]),
            ppool.Pool(pdb.MemDB(), p["states"], p["blocks"], device="cpu"))


def _port_ev(ev):
    return pcodec.decode_evidence(rcodec.encode_evidence(ev))


def _save_state(r, p, **changes) -> None:
    """Both packages' latest state, changed alike (e.g. the evidence
    age window), saved over the old one."""
    st = replace(r["states"].load(), **changes)
    r["states"].save(st)
    p["states"].save(port_state(st))


def _window(r, blocks: int, duration_ns: int) -> dict:
    params = r["states"].load().consensus_params
    return dict(consensus_params=replace(params, evidence=replace(
        params.evidence, max_age_num_blocks=blocks, max_age_duration_ns=duration_ns)))


def _header_time(r, h: int) -> int:
    return r["blocks"].load_block_meta(h).header.time_ns


# -- duplicate votes -------------------------------------------------------------

def _dup(r, h: int = 2, idx: int = 1, **over):
    """DuplicateVoteEvidence of the validator at ``idx`` of the height's
    set: two precommits for blocks ``a`` and ``b`` (``over`` changes the
    votes' or the evidence's fields before it is returned)."""
    _, _, by_addr = chain(**SHAPE)
    vals = r["states"].load_validators(h)
    key = by_addr[vals.validators[idx].address]
    t = _header_time(r, min(h, TOP)) if h <= TOP else _header_time(r, TOP)
    va = signed_precommit(key, idx, _bid(b"a"), h, 0, t + 1)
    vb = signed_precommit(key, idx, _bid(b"b"), h, 0, t + 2)
    ev = rev.DuplicateVoteEvidence.from_votes(va, vb, t, vals)
    return replace(ev, **over)


def _resign(vote, key):
    vote = replace(vote, validator_address=key.pub_key().address(), signature=b"")
    return replace(vote, signature=key.sign(vote.sign_bytes(CHAIN)))


def _key(r, h: int, idx: int):
    return chain(**SHAPE)[2][r["states"].load_validators(h).validators[idx].address]


def _dup_case(case: str, r, p):
    ev = _dup(r)
    if case == "valid":
        return ev
    if case == "different_round":
        return replace(ev, vote_b=_resign(replace(ev.vote_b, round=1), _key(r, 2, 1)))
    if case == "different_validators":
        return replace(ev, vote_b=_resign(ev.vote_b, _key(r, 2, 2)))
    if case == "same_block":
        return replace(ev, vote_b=_resign(replace(ev.vote_b, block_id=ev.vote_a.block_id),
                                          _key(r, 2, 1)))
    if case == "vote_type":
        k = _key(r, 2, 1)
        return replace(ev, vote_a=_resign(replace(ev.vote_a, type=rcanon.PROPOSAL_TYPE), k),
                       vote_b=_resign(replace(ev.vote_b, type=rcanon.PROPOSAL_TYPE), k))
    if case == "wrong_order":
        return replace(ev, vote_a=ev.vote_b, vote_b=ev.vote_a)
    if case == "no_validator_set":
        k = _key(r, 2, 1)
        return replace(ev, vote_a=_resign(replace(ev.vote_a, height=TOP + 40), k),
                       vote_b=_resign(replace(ev.vote_b, height=TOP + 40), k))
    if case == "outsider":
        out = ref_keys(rng(1601), 1)[0]
        return replace(ev, vote_a=_resign(ev.vote_a, out), vote_b=_resign(ev.vote_b, out))
    if case == "power":
        return replace(ev, validator_power=11)
    if case == "total_power":
        return replace(ev, total_voting_power=41)
    if case == "signature":
        sig = ev.vote_b.signature
        return replace(ev, vote_b=replace(ev.vote_b, signature=sig[:5] + bytes([sig[5] ^ 1])
                                          + sig[6:]))
    if case == "no_header":
        return _dup(r, h=TOP + 1)
    if case == "time":
        return replace(ev, timestamp_ns=ev.timestamp_ns + 1)
    if case == "expired":
        _save_state(r, p, **_window(r, 2, 1))
        return ev
    if case == "old_blocks_only":
        _save_state(r, p, **_window(r, 2, 10**18))
        return ev
    if case == "old_time_only":
        _save_state(r, p, **_window(r, 100, 1))
        return ev
    raise AssertionError(case)


DUP_CASES = ("valid", "different_round", "different_validators", "same_block", "vote_type",
             "wrong_order", "no_validator_set", "outsider", "power", "total_power",
             "signature", "no_header", "time", "expired", "old_blocks_only", "old_time_only")


@pytest.mark.parametrize("case", DUP_CASES)
def test_duplicate_vote_verify_equals_the_reference(case):
    r, p = fill(**SHAPE)
    ev = _dup_case(case, r, p)
    rp, pp = _pools(r, p)
    got = outcome(lambda: pp.verify(_port_ev(ev)))
    assert got == outcome(lambda: rp.verify(ev))
    if case in ("valid", "old_blocks_only", "old_time_only"):
        assert got == ("ok",)
    else:
        assert got[0] in ("EvidenceInvalidError", "EvidenceExpiredError", "EvidenceError"), got


# -- light-client attacks --------------------------------------------------------

def _sign_commit(r, header, h: int, signers=None, round_: int = 0, bid=None):
    """A commit of the height's validator set over ``header`` (or
    ``bid``), signed by ``signers`` (indexes; default all)."""
    vals = r["states"].load_validators(min(h, TOP))
    by_addr = chain(**SHAPE)[2]
    if bid is None:
        hh = header.hash()
        bid = rblock.BlockID(hash=hh, part_set_header=rblock.PartSetHeader(total=1,
                                                                           hash=hh[::-1]))
    sigs = []
    for i, v in enumerate(vals.validators):
        if signers is not None and i not in signers:
            sigs.append(rblock.CommitSig(block_id_flag=rblock.BLOCK_ID_FLAG_ABSENT))
            continue
        vote = signed_precommit(by_addr[v.address], i, bid, h, round_, header.time_ns + 7)
        sigs.append(vote.commit_sig())
    return rblock.Commit(height=h, round=round_, block_id=bid, signatures=tuple(sigs))


def _attack(r, conflicting: int = 2, common: int = 1, header=None, commit=None, vals=None,
            **over):
    """LightClientAttackEvidence against the stored chain: by default a
    lunatic header (another app hash) at ``conflicting`` signed by every
    validator of that height, the byzantine list derived as the
    reference's tests derive it."""
    real = r["blocks"].load_block_meta(min(conflicting, TOP)).header
    if header is None:
        header = replace(real, app_hash=b"\xaa" * 32)
    if commit is None:
        commit = _sign_commit(r, header, conflicting)
    if vals is None:
        vals = r["states"].load_validators(min(conflicting, TOP))
    cb = rlb.LightBlock(signed_header=rlb.SignedHeader(header=header, commit=commit),
                        validator_set=vals)
    common_vals = r["states"].load_validators(common)
    ev = rev.LightClientAttackEvidence(
        conflicting_block=cb, common_height=common,
        total_voting_power=common_vals.total_voting_power(),
        timestamp_ns=_header_time(r, common))
    top = min(conflicting, TOP)
    trusted = rlb.SignedHeader(header=r["blocks"].load_block_meta(top).header,
                               commit=r["blocks"].load_block_commit(top)
                               or r["blocks"].load_seen_commit(top))
    byz = ev.get_byzantine_validators(common_vals, trusted)
    ev = replace(ev, byzantine_validators=tuple(v.address for v in byz))
    return replace(ev, **over)


def _lca_case(case: str, r, p):
    if case == "lunatic":
        return _attack(r)
    if case == "forward_lunatic":
        real = r["blocks"].load_block_meta(TOP).header
        header = replace(real, height=TOP + 2, app_hash=b"\xab" * 32,
                         time_ns=real.time_ns - 1)
        return _attack(r, conflicting=TOP + 2, common=TOP - 1, header=header,
                       commit=_sign_commit(r, header, TOP + 2))
    if case == "equivocation":
        real = r["blocks"].load_block_meta(3).header
        header = replace(real, time_ns=real.time_ns + 3, data_hash=b"\x0e" * 32)
        return _attack(r, conflicting=3, common=3, header=header)
    if case == "no_commit":
        ev = _attack(r)
        cb = ev.conflicting_block
        return replace(ev, conflicting_block=replace(cb, signed_header=replace(
            cb.signed_header, commit=replace(cb.commit, signatures=()))))
    if case == "common_not_positive":
        return _attack(r, common=1, common_height=0)
    if case == "common_in_the_future":
        return _attack(r, common=1, common_height=TOP + 1)
    if case == "common_above_conflicting":
        return _attack(r, conflicting=2, common=3)
    if case == "no_common_header":
        ev = _attack(r)
        r["blocks"].prune_blocks(3)
        p["blocks"].prune_blocks(3)
        return ev
    if case == "forward_after_latest":
        real = r["blocks"].load_block_meta(TOP).header
        header = replace(real, height=TOP + 2, app_hash=b"\xab" * 32,
                         time_ns=real.time_ns + 1)
        return _attack(r, conflicting=TOP + 2, common=TOP - 1, header=header,
                       commit=_sign_commit(r, header, TOP + 2))
    if case == "trusting_one_third":
        header = replace(r["blocks"].load_block_meta(2).header, app_hash=b"\xaa" * 32)
        return _attack(r, header=header, commit=_sign_commit(r, header, 2, signers={0}))
    if case == "equivocation_invalid_header":
        real = r["blocks"].load_block_meta(3).header
        return _attack(r, conflicting=3, common=3, header=replace(real, app_hash=b"\xac" * 32))
    if case == "missing_validator_set":
        return _attack(r, vals=rvalidator.ValidatorSet([]))
    if case == "validator_set_mismatch":
        others, _ = _other_set()
        return _attack(r, vals=others)
    if case == "conflicting_commit_short":
        header = replace(r["blocks"].load_block_meta(2).header, app_hash=b"\xaa" * 32)
        return _attack(r, header=header, commit=_sign_commit(r, header, 2, signers={0, 1}))
    if case == "commit_signs_another_header":
        header = replace(r["blocks"].load_block_meta(2).header, app_hash=b"\xaa" * 32)
        other = replace(header, app_hash=b"\xbb" * 32).hash()
        bid = rblock.BlockID(hash=other, part_set_header=rblock.PartSetHeader(
            total=1, hash=other[::-1]))
        return _attack(r, header=header, commit=_sign_commit(r, header, 2, bid=bid))
    if case == "total_power":
        return _attack(r, total_voting_power=41)
    if case == "our_own_header":
        real = r["blocks"].load_block_meta(3)
        return _attack(r, conflicting=3, common=3, header=real.header,
                       commit=r["blocks"].load_block_commit(3))
    if case == "byzantine_list":
        ev = _attack(r)
        return replace(ev, byzantine_validators=ev.byzantine_validators[:1])
    if case == "time":
        ev = _attack(r)
        return replace(ev, timestamp_ns=ev.timestamp_ns - 1)
    if case == "expired":
        _save_state(r, p, **_window(r, 2, 1))
        return _attack(r)
    raise AssertionError(case)


def _other_set():
    keys = ref_keys(rng(1602), 4)
    return rvalidator.ValidatorSet([rvalidator.Validator(k.pub_key(), 10) for k in keys]), keys


LCA_CASES = ("lunatic", "forward_lunatic", "equivocation", "no_commit", "common_not_positive",
             "common_in_the_future", "common_above_conflicting", "no_common_header",
             "forward_after_latest", "trusting_one_third", "equivocation_invalid_header",
             "missing_validator_set", "validator_set_mismatch", "conflicting_commit_short",
             "commit_signs_another_header", "total_power", "our_own_header",
             "byzantine_list", "time", "expired")


@pytest.mark.parametrize("case", LCA_CASES)
def test_light_client_attack_verify_equals_the_reference(case):
    r, p = fill(**SHAPE)
    ev = _lca_case(case, r, p)
    rp, pp = _pools(r, p)
    got = outcome(lambda: pp.verify(_port_ev(ev)))
    assert got == outcome(lambda: rp.verify(ev))
    if case in ("lunatic", "forward_lunatic", "equivocation"):
        assert got == ("ok",)
        assert ev.byzantine_validators
    else:
        assert got[0] in ("EvidenceInvalidError", "EvidenceExpiredError", "EvidenceError"), got


# -- the lifecycle ----------------------------------------------------------------

def _lifecycle(pool, evs, states, metrics) -> list:
    """One scripted sequence on one package's pool -> what each step
    leaves: the step's outcome, the pending hashes and size, the pool's
    DB image and the metrics' exposition."""
    pool.metrics = metrics[0]
    dup1, lca, votes = evs
    steps = [
        ("add", lambda: pool.add_evidence(dup1)),
        ("add_again", lambda: pool.add_evidence(dup1)),
        ("add_lca", lambda: pool.add_evidence(lca)),
        ("report", lambda: pool.report_conflicting_votes(*votes)),
        ("check_pending", lambda: pool.check_evidence([dup1, lca])),
        ("check_duplicate", lambda: pool.check_evidence([dup1, dup1])),
        ("update", lambda: pool.update(states[0], [dup1])),
        ("check_committed", lambda: pool.check_evidence([dup1])),
        ("update_again", lambda: pool.update(states[0], [dup1])),
        ("add_committed", lambda: pool.add_evidence(dup1)),
        ("prune_not_yet", lambda: pool.update(states[1], [])),
        ("prune", lambda: pool.update(states[2], [lca])),
    ]
    out = []
    for name, fn in steps:
        got = outcome(fn)
        pending, size = pool.pending_evidence(-1)
        capped, _ = pool.pending_evidence(size - 1) if size else ([], 0)
        out.append((name, got, [e.hash() for e in pending], size,
                    [e.hash() for e in capped], pool.size(), sorted(image(pool.db).items()),
                    metrics[1].expose()))
    return out


def test_pool_lifecycle_equals_the_reference(monkeypatch):
    """pending -> committed -> pruned across ``update``, the consensus
    buffer turned into evidence, and the refusals of ``check_evidence``,
    step by step alike (DB images, pending lists, metrics)."""
    monkeypatch.setattr(rpool, "now_ns", lambda: FIXED_NOW)
    monkeypatch.setattr(ppool, "now_ns", lambda: FIXED_NOW)
    r, p = fill(**SHAPE)
    dup1 = _dup(r, h=2, idx=1)
    dup2 = _dup(r, h=3, idx=2)
    lca = _attack(r)
    base = r["states"].load()
    later = base.last_block_time_ns + 10 * BLOCK_NS
    win = _window(r, 3, 2 * BLOCK_NS)
    states = [base,
              replace(base, last_block_height=TOP + 1, last_block_time_ns=later, **win),
              replace(base, last_block_height=TOP + 40, last_block_time_ns=later, **win)]
    rp, pp = _pools(r, p)
    rreg, preg = rumetrics.Registry("cometbft"), pumetrics.Registry("cometbft")
    ref = _lifecycle(rp, (dup1, lca, (dup2.vote_a, dup2.vote_b)), states,
                     (rmetrics.EvidenceMetrics(rreg), rreg))
    port = _lifecycle(pp, (_port_ev(dup1), _port_ev(lca),
                              (pvote.Vote.decode(dup2.vote_a.encode()),
                               pvote.Vote.decode(dup2.vote_b.encode()))),
                      [port_state(s) for s in states], (pmetrics.EvidenceMetrics(preg), preg))
    assert port == ref
    by_name = {row[0]: row for row in ref}
    assert by_name["update"][2] == [lca.hash(), dup2.hash()]
    assert by_name["check_committed"][1][0] == "EvidenceAlreadyCommittedError"
    assert by_name["check_duplicate"][1] == ("EvidenceInvalidError",
                                             "duplicate evidence in block")
    assert by_name["prune"][2] == [] and by_name["prune"][6] == []
    assert "cometbft_evidence_committed_total 2" in by_name["prune"][7]


# -- the reactor's codec, the adversary --------------------------------------------

def test_evidence_list_codec_equals_the_reference():
    r, _ = fill(**SHAPE)
    evs = [_dup(r), _attack(r), _dup(r, h=3, idx=0)]
    raw = rreactor.encode_evidence_list(evs)
    port_evs = [_port_ev(e) for e in evs]
    assert preactor.encode_evidence_list(port_evs) == raw
    assert [e.hash() for e in preactor.decode_evidence_list(raw)] == [e.hash() for e in evs]
    assert rreactor.encode_evidence_list(rreactor.decode_evidence_list(
        preactor.encode_evidence_list(port_evs))) == raw
    assert preactor.encode_evidence_list([]) == rreactor.encode_evidence_list([]) == b""
    for bad in (b"\x0a", b"\x0a\x03\x0a\x01\x00", raw[:-3]):
        assert outcome(lambda: preactor.decode_evidence_list(bad)) == \
            outcome(lambda: rreactor.decode_evidence_list(bad))
    d = preactor.EvidenceReactor(None).get_channels()[0]
    rd = rreactor.EvidenceReactor(None).get_channels()[0]
    assert (d.id, d.priority, d.send_queue_capacity, d.recv_message_capacity) == \
        (rd.id, rd.priority, rd.send_queue_capacity, rd.recv_message_capacity)


class _Peer:
    id = "ab" * 20


class _Switch:
    def __init__(self):
        self.stopped = []

    def stop_peer_for_error(self, peer, reason) -> None:
        self.stopped.append((peer.id, reason))


class _RaisingPool:
    def __init__(self, exc):
        self.exc = exc

    def add_evidence(self, ev) -> None:
        raise self.exc


@pytest.mark.parametrize("exc, stops", [
    (ppool.EvidenceExpiredError("evidence from height 2 is too old"), False),
    (ppool.EvidenceAlreadyCommittedError("evidence already committed"), False),
    (ppool.EvidenceInvalidError("invalid vote signature"), True),
    (pev.EvidenceError("duplicate votes in wrong order"), True),
    (RuntimeError("CUDA error: the launch failed"), None),
], ids=["expired", "committed", "invalid", "malformed", "launch_failed"])
def test_evidence_reactor_keeps_stops_or_raises(exc, stops):
    """The reactor keeps a peer whose evidence is expired or already
    committed, stops one whose evidence is invalid, and lets any other
    error out of ``receive`` (a kernel that fails in the attack check is
    not swallowed as a benign refusal)."""
    r, _ = fill(**SHAPE)
    reactor = preactor.EvidenceReactor(_RaisingPool(exc))
    reactor.switch = _Switch()
    env = Envelope(channel_id=preactor.EVIDENCE_CHANNEL, src=_Peer(),
                   message=preactor.encode_evidence_list([_port_ev(_dup(r))]))
    if stops is None:
        with pytest.raises(type(exc), match=str(exc)):
            reactor.receive(env)
        assert reactor.switch.stopped == []
        return
    reactor.receive(env)
    assert reactor.switch.stopped == ([(_Peer.id, exc)] if stops else [])


class _Signer:
    """What the equivocation hook reads of a FilePV: its raw key."""

    def __init__(self, key):
        self._priv_key = key


def _hooks(byz, key, vote, parts) -> tuple:
    sent = []
    byz.register_broadcast(sent.append)
    byz.maybe_equivocate(vote, _Signer(key), CHAIN)
    byz.maybe_equivocate(vote, _Signer(key), CHAIN)      # once per height
    byz.maybe_equivocate(replace(vote, height=vote.height + 1, block_id=type(
        vote.block_id)()), _Signer(key), CHAIN)          # a nil precommit: none
    stx = byz.maybe_forge_stx((b"a=1", b"b=2"))
    corrupted = [byz.maybe_corrupt_part(part).bytes for part in parts]
    return sent, stx, corrupted


@pytest.mark.parametrize("mode", [None, "equivocate", "forge_stx", "corrupt_parts"])
def test_byzantine_hooks_equal_the_reference(monkeypatch, mode):
    """Each hook of the port's ``Byz(mode)`` gives the bytes the
    reference's process-wide adversary gives when CMT_TPU_BYZ arms it
    with the same mode; unarmed, every hook is a no-op."""
    key = red.priv_key_from_secret(b"byz-hooks")
    vote = signed_precommit(key, 0, _bid(b"v"), 5, 1, 1_700_000_000_000_000_000)
    data = bytes(range(256)) * 3
    rps, pps = rparts.PartSet.from_bytes(data, 64), pparts.PartSet.from_bytes(data, 64)
    monkeypatch.setenv("CMT_TPU_BYZ", mode or "")
    rbyz.BYZ._reset_for_tests()
    rbyz.BYZ.reload()
    try:
        ref = _hooks(rbyz.BYZ, key, vote, [rps.get_part(i) for i in range(rps.header.total)])
    finally:
        rbyz.BYZ._reset_for_tests()
    port = _hooks(pbyz.Byz(mode), ped.priv_key_from_secret(b"byz-hooks"),
                  pvote.Vote.decode(vote.encode()),
                  [pps.get_part(i) for i in range(pps.header.total)])
    assert port == ref
    sent, stx, corrupted = port
    assert len(sent) == (1 if mode == "equivocate" else 0)
    assert len(stx) == (3 if mode == "forge_stx" else 2)
    assert sum(c != pps.get_part(i).bytes for i, c in enumerate(corrupted)) == \
        (pps.header.total // 4 if mode == "corrupt_parts" else 0)
    with pytest.raises(ValueError, match="byzantine mode"):
        pbyz.Byz("flood")


def test_a_forging_port_proposer_is_refused_as_the_reference_refuses(monkeypatch):
    """``BlockExecutor(byz=Byz("forge_stx")).create_proposal_block``
    gives the block the reference proposes with CMT_TPU_BYZ=forge_stx
    (the same bytes, the forged envelope last), and every honest
    ``process_proposal``, the port's and the reference's, refuses it."""
    from cometbft_tpu import proxy as rproxy, state as rstate
    from cometbft_tpu.abci import kvstore as rkv, types as rtypes
    from cometbft_tpu.state import execution as rexec
    from cometbft_tpu.types import genesis as rgenesis
    import cometbft_tpu.mempool as rmempool
    from cometbft_tpu_torch import proxy as pproxy, state as pstate
    from cometbft_tpu_torch.abci import kvstore as pkv, types as ptypes
    from cometbft_tpu_torch.state import execution as pexec
    from cometbft_tpu_torch.types import genesis as pgenesis
    import cometbft_tpu_torch.mempool as pmempool
    from tests.test_torch_mempool import _exec_side

    g = rng(160)
    keys = [red.priv_key_from_secret(g.bytes(32)) for _ in range(4)]
    gen_json = rgenesis.GenesisDoc(chain_id=CHAIN, genesis_time_ns=FIXED_NOW, validators=tuple(
        rgenesis.GenesisValidator(k.pub_key(), 10) for k in keys)).to_json()
    txs = [b"k%d=v%d" % (i, i) for i in range(3)]
    rmods = (rgenesis, rstate, rkv, rproxy, rdb, rexec, rmempool, rtypes, {})
    pmods = (pgenesis, pstate, pkv, pproxy, pdb, pexec, pmempool, ptypes, dict(device="cpu"))
    ref_ex, rst = _exec_side(rmods, gen_json, txs)
    forger, pst = _exec_side(pmods, gen_json, txs, byz=pbyz.Byz("forge_stx"))
    honest, _ = _exec_side(pmods, gen_json, txs)
    proposer = rst.validators.get_proposer().address
    monkeypatch.setenv("CMT_TPU_BYZ", "forge_stx")
    rbyz.BYZ._reset_for_tests()
    rbyz.BYZ.reload()
    try:
        rb = ref_ex.create_proposal_block(1, rst, None, proposer)
    finally:
        rbyz.BYZ._reset_for_tests()
    pb = forger.create_proposal_block(1, pst, None, proposer)
    assert pcodec.encode_block(pb) == rcodec.encode_block(rb) and pb.hash() == rb.hash()
    assert list(pb.data.txs[:-1]) == txs and pb.data.txs[-1].endswith(b":byz_forged=1")
    assert list(honest.create_proposal_block(1, pst, None, proposer).data.txs) == txs
    assert honest.process_proposal(pb, pst) is ref_ex.process_proposal(rb, rst) is False


# -- the slice whole: an equivocation committed in a mixed network ---------------------

from tests.test_torch_consensus import (  # noqa: E402 -- the network harness
    PORT, REF, join, network_genesis, stop_node, wait_heights)

WAIT = 60.0
# steps long enough that four nodes in one interpreter keep to one
# round, and a commit timeout that holds each height's last commit open
# for a twin sent late (``_late_votes``)
TIMEOUTS = dict(timeout_propose_ns=400 * 10**6, timeout_vote_ns=100 * 10**6,
                timeout_commit_ns=300 * 10**6)


def make_ev_node(side: dict, secret: bytes, gen_json: str, byz=None) -> dict:
    """One validator of ``side``'s package as tests/test_torch_consensus.py
    assembles it, with an evidence pool in its executor and an evidence
    reactor on its switch; ``byz``, a port node's adversary, goes to its
    executor."""
    import importlib

    ev_mod = importlib.import_module(
        ("cometbft_tpu_torch" if side["port"] else "cometbft_tpu") + ".evidence")
    kw = dict(device="cpu") if side["port"] else {}
    gen = side["genesis"].GenesisDoc.from_json(gen_json)
    nop = side["log"].NopLogger()
    pv = side["privval"].FilePV(side["ed"].priv_key_from_secret(secret))
    dbs = dict(b=side["db"].MemDB(), s=side["db"].MemDB(), a=side["db"].MemDB(),
               e=side["db"].MemDB())
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
    n["pool"] = ev_mod.Pool(dbs["e"], n["states"], n["blocks"], logger=nop, **kw)
    n["exec"] = side["execution"].BlockExecutor(n["states"], n["conns"].consensus, n["mempool"],
                                                evidence_pool=n["pool"],
                                                block_store=n["blocks"], event_bus=n["bus"],
                                                logger=nop, **kw,
                                                **({} if byz is None else dict(byz=byz)))
    n["state"] = side["consensus"].Handshaker(n["states"], state, n["blocks"], gen,
                                              logger=nop, **kw).handshake(n["conns"])
    consensus = replace(side["config"].test_config().consensus, **TIMEOUTS)
    n["cs"] = side["consensus"].ConsensusState(consensus, n["state"], n["exec"], n["blocks"],
                                               priv_validator=pv, event_bus=n["bus"],
                                               logger=nop, **kw)
    n["services"].append(n["cs"])
    n["cr"] = side["creactor"].ConsensusReactor(n["cs"], wait_sync=True, logger=nop)
    n["er"] = ev_mod.EvidenceReactor(n["pool"], logger=nop)
    n["sw"] = side["util"].make_switch(network=gen.chain_id,
                                       reactors={"CONSENSUS": n["cr"], "EVIDENCE": n["er"]})
    n["sw"].start()
    n["services"].append(n["sw"])
    return n


def _evidence_blocks(n, top: int | None = None) -> list:
    top = n["blocks"].height() if top is None else top
    return [(h, ev.hash()) for h in range(1, top + 1)
            for ev in n["blocks"].load_block(h).evidence]


def _counting(byz, into: list):
    """Wrap ``byz``'s part hook to note, per part sent, whether it
    corrupted it."""
    hook = byz.maybe_corrupt_part

    def counted(part):
        out = hook(part)
        into.append(out is not part)
        return out

    byz.maybe_corrupt_part = counted
    return byz


def _late_votes(broadcast, delay_s: float = 0.15):
    """``broadcast`` with its vote-channel sends (only the equivocator's
    twin goes that way) made ``delay_s`` late, inside the peers' commit
    timeout.  Sent at once, the twin reaches every peer before the real
    precommit's gossip; each peer then tells the equivocator it holds its
    vote, and the real one is never gossiped to it, so no peer sees both.
    Sent late, it meets the real one in every peer's vote set or last
    commit."""
    from cometbft_tpu_torch.consensus.reactor import VOTE_CHANNEL

    def late(ch_id, raw):
        if ch_id != VOTE_CHANNEL:
            return broadcast(ch_id, raw)
        t = threading.Timer(delay_s, broadcast, (ch_id, raw))
        t.daemon = True
        t.start()

    return late


@pytest.fixture(scope="module", params=["reference", "port"])
def equivocation_net(request):
    """Two port and two reference validators, one armed to equivocate,
    until a block carrying the evidence is committed on every node.
    ``reference``: reference validator 1, armed as the reference arms it
    (CMT_TPU_BYZ=equivocate, its process-wide adversary, limited to that
    validator), broadcasting on its own switch.  ``port``: port validator
    0, built with ``BlockExecutor(byz=Byz("equivocate"))``, which its
    consensus state and reactor wire up themselves, and port validator 2
    with ``Byz("corrupt_parts")``, run until it has corrupted a block
    part it gossiped; the equivocator's twin leaves its switch late
    (``_late_votes``).  -> (the nodes' stores, the genesis, the
    equivocator's address, the parts corrupted)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CMT_TPU_DISABLE_DEVICE_VERIFY", "1")
    secrets = [b"evnet-%d" % i for i in range(4)]
    gen_json = network_genesis(secrets)
    by_port = request.param == "port"
    corrupted: list = []
    advs = ([pbyz.Byz("equivocate"), None, _counting(pbyz.Byz("corrupt_parts"), corrupted),
             None] if by_port else [None] * 4)
    nodes = []
    rbyz.BYZ._reset_for_tests()
    try:
        for side, secret, adv in zip([PORT, REF, PORT, REF], secrets, advs):
            nodes.append(make_ev_node(side, secret, gen_json, byz=adv))
        byz_pv = nodes[0 if by_port else 1]["pv"]
        if not by_port:
            mp.setenv("CMT_TPU_BYZ", "equivocate")
            rbyz.BYZ.reload()
            armed = rbyz.BYZ.maybe_equivocate
            mp.setattr(rbyz.BYZ, "maybe_equivocate",
                       lambda vote, pv, chain_id: armed(vote, pv, chain_id)
                       if pv is byz_pv else None)
        if by_port:
            nodes[0]["sw"].broadcast = _late_votes(nodes[0]["sw"].broadcast)
        join(nodes, nodes)
        if not by_port:
            rbyz.BYZ.register_broadcast(
                lambda raw: nodes[1]["sw"].broadcast(rcreactor.VOTE_CHANNEL, raw))
        for n in nodes:
            n["cr"].switch_to_consensus(n["state"])
        deadline = time.monotonic() + WAIT
        while not (all(_evidence_blocks(n) for n in nodes) and (any(corrupted) or not by_port)):
            assert time.monotonic() < deadline, ([n["blocks"].height() for n in nodes],
                                                 sum(corrupted))
            time.sleep(0.05)
        rbyz.BYZ._reset_for_tests()
        for adv in advs:
            if adv is not None:
                adv.mode = None
        wait_heights(nodes, max(n["blocks"].height() for n in nodes) + 2)
    finally:
        rbyz.BYZ._reset_for_tests()
        mp.undo()
        for n in nodes:
            stop_node(n)
    yield nodes, gen_json, byz_pv.address, sum(corrupted)


def test_equivocation_is_committed_and_every_store_agrees(equivocation_net):
    nodes, _, byz_addr, n_corrupted = equivocation_net
    # in the port's case the equivocator is port node 0 and port node 2
    # corrupted parts, each through its executor's adversary
    assert (n_corrupted > 0) == (byz_addr == nodes[0]["pv"].address)
    assert all(n["cs"].byz is n["exec"].byz for n in (nodes[0], nodes[2]))
    h = min(n["blocks"].height() for n in nodes)
    for k in range(1, h + 1):
        assert len({n["blocks"].load_block_meta(k).block_id.hash for n in nodes}) == 1, k
        assert len({n["states"].load_finalize_block_response(k).app_hash
                    for n in nodes}) == 1, k
    found = _evidence_blocks(nodes[0], h)
    assert found and all(_evidence_blocks(n, h) == found for n in nodes[1:])
    ev = nodes[0]["blocks"].load_block(found[0][0]).evidence[0]
    assert ev.vote_a.validator_address == byz_addr
    assert ev.vote_a.block_id.key() != ev.vote_b.block_id.key()
    for n in nodes:   # committed: no longer pending anywhere, its marker kept
        assert n["pool"]._is_committed(ev)
        assert ev.hash() not in [e.hash() for e in n["pool"].pending_evidence(-1)[0]]


def test_a_fresh_port_node_blocksyncs_past_the_evidence(equivocation_net, monkeypatch):
    """A port node with an evidence pool blocksyncs the network's chain
    from a reference validator's stores over TCP: its pool verifies the
    committed evidence, and its blocks and app hashes equal the
    network's past that block."""
    from cometbft_tpu.blocksync import reactor as rbs
    from cometbft_tpu_torch.abci.kvstore import KVStoreApp
    from cometbft_tpu_torch.blocksync import reactor as pbs
    from cometbft_tpu_torch.consensus import Handshaker
    from cometbft_tpu_torch.mempool import NopMempool
    from cometbft_tpu_torch.p2p.test_util import make_switch as pswitch
    from cometbft_tpu_torch.proxy import local_client_creator, new_app_conns
    from cometbft_tpu_torch.state import Store, load_state_from_db_or_genesis
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.genesis import GenesisDoc
    from cometbft_tpu_torch.utils.log import NopLogger
    from tests.test_torch_blocksync import ConsensusRecorder

    nodes, gen_json, _, _ = equivocation_net
    src = nodes[1]                                   # a reference validator's stores
    ev_height = _evidence_blocks(src)[0][0]
    monkeypatch.setattr(pbs, "SWITCH_TO_CONSENSUS_INTERVAL", 0.05)
    gen = GenesisDoc.from_json(gen_json)
    states, blocks = Store(pdb.MemDB()), BlockStore(pdb.MemDB())
    app = KVStoreApp(pdb.MemDB())
    conns = new_app_conns(local_client_creator(app))
    state = Handshaker(states, load_state_from_db_or_genesis(states, gen), blocks, gen,
                       logger=NopLogger(), device="cpu").handshake(conns)
    pool = ppool.Pool(pdb.MemDB(), states, blocks, logger=NopLogger(), device="cpu")
    exe = BlockExecutor(states, conns.consensus, NopMempool(), evidence_pool=pool,
                        block_store=blocks, logger=NopLogger(), device="cpu")
    recorder = ConsensusRecorder()
    syncer = pswitch(reactors={"BLOCKSYNC": pbs.BlocksyncReactor(
        state, exe, blocks, True, consensus_reactor=recorder, logger=NopLogger(),
        device="cpu")})
    from cometbft_tpu.p2p.test_util import make_switch as rswitch
    from cometbft_tpu.utils.log import NopLogger as RNop

    server = rswitch(reactors={"BLOCKSYNC": rbs.BlocksyncReactor(
        src["states"].load(), None, src["blocks"], False, logger=RNop())})
    try:
        server.start()
        syncer.start()
        syncer.dial_peer_with_address(server.transport.listen_addr)
        assert recorder.done.wait(WAIT), blocks.height()
    finally:
        for sw in (syncer, server):
            if sw.is_running():
                sw.stop()
    top = blocks.height()
    assert top > ev_height and recorder.states[0].last_block_height == top
    for k in range(1, top + 1):
        assert blocks.load_block_meta(k).block_id.encode() == \
            src["blocks"].load_block_meta(k).block_id.encode()
        assert states.load_finalize_block_response(k).app_hash == \
            src["states"].load_finalize_block_response(k).app_hash
    ev = blocks.load_block(ev_height).evidence[0]
    assert pool._is_committed(ev) and pool.pending_evidence(-1) == ([], 0)
