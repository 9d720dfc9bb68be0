"""The port's types layer (cometbft_tpu_torch/{types,crypto/merkle,
crypto/tmhash,utils/protoio,utils/bit_array}) against the reference's
(cometbft_tpu/...), which imports no jax for these modules.  The same
inputs, made from a seed with numpy, go to both packages; state crosses
from the reference to the port through the port's codec
(``decode_header``, ``decode_commit``, ``Vote.decode``) and validator
sets through ``(pub_key.bytes(), voting_power, proposer_priority)``.
Tolerance: byte for byte -- sign bytes, hashes, merkle roots and
proofs, varints, codec bytes in both directions, proposer priorities,
vote-set tallies and ``make_commit``'s bytes.

The helpers at the top (keys, sets, votes, commits, the carry across)
are shared with tests/test_torch_validation.py and
tests/test_torch_light.py.  Signing is the reference's (OpenSSL when
``cryptography`` is installed); Ed25519 is deterministic, so the port's
keys give the same signatures."""

from dataclasses import replace

import numpy as np
import pytest

from cometbft_tpu.crypto import ed25519 as red
from cometbft_tpu.crypto import merkle as rmerkle
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import canonical as rcanon
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types import validator as rvalidator
from cometbft_tpu.types import vote as rvote
from cometbft_tpu.types import vote_set as rvote_set
from cometbft_tpu.utils import bit_array as rbits
from cometbft_tpu.utils import protoio as rproto
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.crypto import merkle as pmerkle
from cometbft_tpu_torch.crypto import tmhash as ptmhash
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import canonical as pcanon
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.types import validator as pvalidator
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types import vote_set as pvote_set
from cometbft_tpu_torch.utils import bit_array as pbits
from cometbft_tpu_torch.utils import protoio as pproto
from cometbft_tpu_torch.version import BLOCK_PROTOCOL

SEED = 0x7E10
CHAIN = "parity-chain"
T0 = 1_700_000_000_123_456_789


# -- shared helpers ----------------------------------------------------------

def rng(tag: int) -> np.random.Generator:
    return np.random.default_rng(SEED + tag)


def ref_keys(g: np.random.Generator, n: int) -> list:
    """``n`` reference keys from secrets drawn from ``g``."""
    return [red.priv_key_from_secret(g.bytes(32)) for _ in range(n)]


def ref_val_set(keys, powers=None):
    """(the reference's ValidatorSet, the keys in the set's order)."""
    powers = powers or [10] * len(keys)
    vals = rvalidator.ValidatorSet(
        [rvalidator.Validator(k.pub_key(), p) for k, p in zip(keys, powers)])
    by_addr = {k.pub_key().address(): k for k in keys}
    return vals, [by_addr[v.address] for v in vals.validators]


def port_val_set(ref_vals) -> pvalidator.ValidatorSet:
    """The reference's set carried into the port: each validator's key
    bytes, power and priority through the port's key type."""
    return pvalidator.ValidatorSet([
        pvalidator.Validator(ped.Ed25519PubKey(v.pub_key.bytes()), v.voting_power,
                             v.proposer_priority)
        for v in ref_vals.validators])


def block_id(g: np.random.Generator, mod=rblock):
    h = g.bytes(32)
    return mod.BlockID(hash=h, part_set_header=mod.PartSetHeader(
        total=int(g.integers(1, 100)), hash=g.bytes(32)))


def port_block_id(bid) -> pblock.BlockID:
    return pcodec.decode_block_id(bid.encode())


def signed_precommit(key, idx: int, bid, height: int, round_: int, time_ns: int,
                     chain_id: str = CHAIN, vote_type: int = rcanon.PRECOMMIT_TYPE):
    """A reference vote signed over its canonical sign bytes."""
    vote = rvote.Vote(type=vote_type, height=height, round=round_, block_id=bid,
                      timestamp_ns=time_ns, validator_address=key.pub_key().address(),
                      validator_index=idx)
    return replace(vote, signature=key.sign(vote.sign_bytes(chain_id)))


def ref_commit(keys, bid, height: int, g: np.random.Generator, round_: int = 0,
               signers=None, chain_id: str = CHAIN, base_ns: int = T0):
    """A commit signed by ``signers`` (default: every key), each
    precommit with its own timestamp, as a real commit carries."""
    sigs = []
    for i, k in enumerate(keys):
        if signers is not None and i not in signers:
            sigs.append(rblock.CommitSig(block_id_flag=rblock.BLOCK_ID_FLAG_ABSENT))
            continue
        t = base_ns + int(g.integers(0, 1_000_000_000))
        sigs.append(signed_precommit(k, i, bid, height, round_, t, chain_id).commit_sig())
    return rblock.Commit(height=height, round=round_, block_id=bid, signatures=tuple(sigs))


def port_commit(commit) -> pblock.Commit:
    """The reference's commit carried into the port by its wire bytes."""
    return pcodec.decode_commit(rcodec.encode_commit(commit))


def port_header(header) -> pblock.Header:
    return pcodec.decode_header(rcodec.encode_header(header))


def random_header(g: np.random.Generator, height: int | None = None, mod=rblock):
    return mod.Header(
        chain_id=CHAIN, height=int(g.integers(1, 1 << 40)) if height is None else height,
        time_ns=T0 + int(g.integers(0, 1 << 50)), last_block_id=block_id(g, mod),
        last_commit_hash=g.bytes(32), data_hash=g.bytes(32), validators_hash=g.bytes(32),
        next_validators_hash=g.bytes(32), consensus_hash=g.bytes(32), app_hash=g.bytes(32),
        last_results_hash=g.bytes(32), evidence_hash=g.bytes(32),
        proposer_address=g.bytes(20), version_app=int(g.integers(0, 5)))


def outcome(fn) -> tuple:
    """("ok",) or (exception class name, message)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 -- the outcome is compared
        return type(exc).__name__, str(exc)
    return ("ok",)


# -- protoio -----------------------------------------------------------------

UVARINTS = [0, 1, 127, 128, 255, 300, 16383, 16384, (1 << 32) - 1, 1 << 35,
            (1 << 63) - 1, (1 << 64) - 1]


@pytest.mark.parametrize("n", UVARINTS)
def test_uvarint_and_length_prefix_equal_reference(n):
    enc = pproto.encode_uvarint(n)
    assert enc == rproto.encode_uvarint(n)
    assert pproto.decode_uvarint(enc + b"\x01") == rproto.decode_uvarint(enc + b"\x01")
    payload = bytes(n % 300)
    assert pproto.length_prefixed(payload) == rproto.length_prefixed(payload)
    assert pproto.read_length_prefixed(pproto.length_prefixed(payload)) == \
        rproto.read_length_prefixed(rproto.length_prefixed(payload))


@pytest.mark.parametrize("bad", [b"", b"\x80", b"\xff" * 10 + b"\x01", b"\xff" * 9 + b"\x02"])
def test_uvarint_refusals_equal_reference(bad):
    assert outcome(lambda: pproto.decode_uvarint(bad)) == \
        outcome(lambda: rproto.decode_uvarint(bad))


@pytest.mark.parametrize("trial", range(4))
def test_proto_writer_and_reader_equal_reference(trial):
    g = rng(100 + trial)
    ops = []
    for field in range(1, 16):
        kind = ["varint", "svarint", "sfixed64", "fixed64", "bytes_", "string", "message",
                "bool_"][int(g.integers(0, 8))]
        if kind in ("varint", "svarint", "sfixed64"):
            v = int(g.integers(-(1 << 62), 1 << 62))
        elif kind == "fixed64":
            v = int(g.integers(0, 1 << 62))
        elif kind == "bool_":
            v = bool(g.integers(0, 2))
        elif kind == "string":
            v = g.bytes(int(g.integers(0, 20))).hex()
        else:
            v = g.bytes(int(g.integers(0, 40)))
        ops.append((kind, field, v))
    outs = []
    for mod in (pproto, rproto):
        w = mod.ProtoWriter()
        for kind, field, v in ops:
            getattr(w, kind)(field, v)
        outs.append(w.finish())
    assert outs[0] == outs[1]
    assert list(pproto.ProtoReader(outs[0]).fields()) == list(rproto.ProtoReader(outs[1]).fields())
    assert pproto.int64_from_varint((1 << 64) - 5) == rproto.int64_from_varint((1 << 64) - 5)


# -- tmhash, merkle ----------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 8, 13])
def test_merkle_roots_and_proofs_equal_reference(n):
    g = rng(200 + n)
    items = [g.bytes(int(g.integers(0, 70))) for _ in range(n)]
    assert pmerkle.hash_from_byte_slices(items) == rmerkle.hash_from_byte_slices(items)
    proot, pproofs = pmerkle.proofs_from_byte_slices(items)
    rroot, rproofs = rmerkle.proofs_from_byte_slices(items)
    assert proot == rroot
    assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in pproofs] == \
        [(p.total, p.index, p.leaf_hash, p.aunts) for p in rproofs]
    for i, (pp, item) in enumerate(zip(pproofs, items)):
        wire = pmerkle.proof_to_bytes(pp)
        assert wire == rmerkle.proof_to_bytes(rproofs[i])
        back = pmerkle.proof_from_bytes(rmerkle.proof_to_bytes(rproofs[i]))
        assert back == pp and back.verify(proot, item)
        assert back.compute_root() == rproofs[i].compute_root()
        assert not back.verify(proot, item + b"x")
    key, value = g.bytes(7), g.bytes(int(g.integers(0, 200)))
    assert pmerkle.kv_leaf(key, value) == rmerkle.kv_leaf(key, value)
    assert ptmhash.sum_truncated(key) == ptmhash.sum256(key)[:20]


# -- canonical sign bytes ----------------------------------------------------

@pytest.mark.parametrize("trial", range(6))
def test_canonical_sign_bytes_equal_reference(trial):
    g = rng(300 + trial)
    height, round_ = int(g.integers(0, 1 << 40)), int(g.integers(0, 1 << 10)) * (trial % 2)
    t = T0 + int(g.integers(-(1 << 40), 1 << 40))
    rbid = block_id(g) if trial != 2 else rblock.NIL_BLOCK_ID
    pbid = port_block_id(rbid)
    for msg_type in (rcanon.PREVOTE_TYPE, rcanon.PRECOMMIT_TYPE):
        assert pcanon.vote_sign_bytes(CHAIN, msg_type, height, round_, pbid, t) == \
            rcanon.vote_sign_bytes(CHAIN, msg_type, height, round_, rbid, t)
    pol = int(g.integers(-1, 5))
    assert pcanon.proposal_sign_bytes(CHAIN, height, round_, pol, pbid, t) == \
        rcanon.proposal_sign_bytes(CHAIN, height, round_, pol, rbid, t)
    ext = g.bytes(int(g.integers(0, 50)))
    assert pcanon.vote_extension_sign_bytes(CHAIN, height, round_, ext) == \
        rcanon.vote_extension_sign_bytes(CHAIN, height, round_, ext)
    assert pcanon.encode_timestamp(t) == rcanon.encode_timestamp(t)
    assert pcodec.decode_timestamp(rcanon.encode_timestamp(t)) == t
    # Vote and Proposal sign bytes, encodings and decodings
    rv = rvote.Vote(type=rcanon.PRECOMMIT_TYPE, height=height, round=round_, block_id=rbid,
                    timestamp_ns=t, validator_address=g.bytes(20),
                    validator_index=int(g.integers(0, 100)), signature=g.bytes(64),
                    extension=ext, extension_signature=g.bytes(64) if ext else b"")
    pv = pvote.Vote.decode(rv.encode())
    assert pv.encode() == rv.encode()
    assert pv.sign_bytes(CHAIN) == rv.sign_bytes(CHAIN)
    assert pv.extension_sign_bytes(CHAIN) == rv.extension_sign_bytes(CHAIN)
    assert pcodec.encode_commit(pblock.Commit(signatures=(pv.commit_sig(),))) == \
        rcodec.encode_commit(rblock.Commit(signatures=(rv.commit_sig(),)))
    assert outcome(pv.validate_basic) == outcome(rv.validate_basic)
    rp = rvote.Proposal(height=height, round=round_ + 1, pol_round=min(pol, round_),
                        block_id=rbid, timestamp_ns=t, signature=g.bytes(64))
    pp = pvote.Proposal.decode(rp.encode())
    assert pp.encode() == rp.encode() and pp.sign_bytes(CHAIN) == rp.sign_bytes(CHAIN)
    assert outcome(pp.validate_basic) == outcome(rp.validate_basic)


# -- header, commit, validator set: hashes and the codec ---------------------

@pytest.mark.parametrize("trial", range(4))
def test_header_hash_and_codec_equal_reference(trial):
    g = rng(400 + trial)
    rh = random_header(g)
    if trial == 3:
        rh = replace(rh, validators_hash=b"")     # not hashable yet: None in both
    raw = rcodec.encode_header(rh)
    ph = pcodec.decode_header(raw)
    assert pcodec.encode_header(ph) == raw
    assert ph.hash() == rh.hash()
    assert ph.version_block == rh.version_block == BLOCK_PROTOCOL
    # the port's own header crosses back the same way
    assert rcodec.decode_header(pcodec.encode_header(ph)) == rh


@pytest.mark.parametrize("nval", [4, 7, 10])
def test_commit_hash_codec_and_sign_bytes_equal_reference(nval):
    g = rng(500 + nval)
    vals, keys = ref_val_set(ref_keys(g, nval))
    bid = block_id(g)
    signers = set(range(nval)) - {1}
    rc = ref_commit(keys, bid, 9, g, round_=2, signers=signers)
    raw = rcodec.encode_commit(rc)
    pc = pcodec.decode_commit(raw)
    assert pcodec.encode_commit(pc) == raw
    assert rcodec.decode_commit(pcodec.encode_commit(pc)) == rc
    assert pc.hash() == rc.hash()
    for i in range(nval):
        assert pc.vote_sign_bytes(CHAIN, i) == rc.vote_sign_bytes(CHAIN, i)
    assert pc.aggregate_sign_bytes(CHAIN) == rc.aggregate_sign_bytes(CHAIN)
    agg = replace(rc, agg_signature=g.bytes(96))
    pagg = port_commit(agg)
    assert pagg.hash() == agg.hash()
    assert [pagg.is_aggregated(i) for i in range(nval)] == [agg.is_aggregated(i) for i in range(nval)]
    for c, r in ((pc, rc), (pagg, agg), (replace(pc, height=-1), replace(rc, height=-1)),
                 (replace(pc, signatures=()), replace(rc, signatures=()))):
        assert outcome(c.validate_basic) == outcome(r.validate_basic)
    pvals = port_val_set(vals)
    assert pvals.hash() == vals.hash()
    assert [v.address for v in pvals.validators] == [v.address for v in vals.validators]
    assert pvals.total_voting_power() == vals.total_voting_power()


def test_data_and_tx_hash_equal_reference():
    g = rng(600)
    txs = tuple(g.bytes(int(g.integers(1, 90))) for _ in range(6))
    assert pblock.Data(txs).hash() == rblock.Data(txs).hash()
    assert pblock.tx_hash(txs[0]) == rblock.tx_hash(txs[0])
    assert pblock.Block(port_header(random_header(g))).validate_basic() is None


# -- proposer rotation and validator-set changes -----------------------------

@pytest.mark.parametrize("times", [1, 3, 17])
def test_proposer_rotation_equals_reference(times):
    g = rng(700 + times)
    powers = [int(p) for p in g.integers(1, 100, 6)]
    vals, _ = ref_val_set(ref_keys(g, 6), powers)
    pvals = port_val_set(vals)
    for _ in range(3):
        vals = vals.increment_proposer_priority(times)
        pvals = pvals.increment_proposer_priority(times)
        assert [(v.address, v.voting_power, v.proposer_priority) for v in pvals.validators] == \
            [(v.address, v.voting_power, v.proposer_priority) for v in vals.validators]
        assert pvals.get_proposer().address == vals.get_proposer().address
        assert pvals.hash() == vals.hash()


def test_update_with_change_set_equals_reference():
    g = rng(800)
    keys = ref_keys(g, 8)
    vals, _ = ref_val_set(keys[:5], [10, 20, 30, 40, 50])
    vals = vals.increment_proposer_priority(2)
    pvals = port_val_set(vals)
    pk = lambda k: ped.Ed25519PubKey(k.pub_key().bytes())  # noqa: E731
    changes = [(keys[0], 0), (keys[1], 25), (keys[5], 15), (keys[6], 70)]
    vals2 = vals.update_with_change_set([(k.pub_key(), p) for k, p in changes])
    pvals2 = pvals.update_with_change_set([(pk(k), p) for k, p in changes])
    assert [(v.address, v.voting_power, v.proposer_priority) for v in pvals2.validators] == \
        [(v.address, v.voting_power, v.proposer_priority) for v in vals2.validators]
    assert pvals2.hash() == vals2.hash()
    for bad in ([(keys[7], 0)], [(keys[2], -1)], [(keys[2], 5), (keys[2], 6)],
                [(k, 0) for k in keys[:5]]):
        assert outcome(lambda: pvals.update_with_change_set([(pk(k), p) for k, p in bad])) == \
            outcome(lambda: vals.update_with_change_set([(k.pub_key(), p) for k, p in bad]))


# -- bit array, vote set -----------------------------------------------------

def test_bit_array_equals_reference():
    g = rng(900)
    bits = [bool(b) for b in g.integers(0, 2, 21)]
    pa, ra = pbits.BitArray(21), rbits.BitArray(21)
    for i, b in enumerate(bits):
        pa.set_index(i, b)
        ra.set_index(i, b)
    pb = pbits.BitArray.from_bytes(13, g.bytes(2))
    rb = rbits.BitArray.from_bytes(13, pb.to_bytes())
    for op in ("or_", "and_", "sub"):
        assert getattr(pa, op)(pb).to_bytes() == getattr(ra, op)(rb).to_bytes()
    assert pa.not_().to_bytes() == ra.not_().to_bytes()
    assert pa.true_indices() == ra.true_indices() and pa.is_full() == ra.is_full()
    assert repr(pa) == repr(ra)


def _vote_sets(nval: int, tag: int, powers=None):
    g = rng(1000 + tag)
    vals, keys = ref_val_set(ref_keys(g, nval), powers)
    return (g, keys, rvote_set.VoteSet(CHAIN, 3, 1, rcanon.PRECOMMIT_TYPE, vals),
            pvote_set.VoteSet(CHAIN, 3, 1, pcanon.PRECOMMIT_TYPE, port_val_set(vals)))


def _tally(vs) -> tuple:
    maj = vs.two_thirds_majority()
    return (vs.has_two_thirds_majority(), maj.encode() if maj else None,
            vs.has_two_thirds_any(), vs.has_all(), vs.sum_voting_power(),
            vs.bit_array().to_bytes())


@pytest.mark.parametrize("nval", [4, 7, 10])
def test_vote_set_majorities_and_make_commit_equal_reference(nval):
    """A nil vote, a vote for another block, the rest for one block:
    no majority at 4 validators, +2/3 at the last votes at 7 and 10."""
    g, keys, rvs, pvs = _vote_sets(nval, nval)
    win, lose = block_id(g), block_id(g)
    plan = [(i, {1: rblock.NIL_BLOCK_ID, 2: lose}.get(i, win)) for i in range(nval)]
    for i, bid in plan:
        rv = signed_precommit(keys[i], i, bid, 3, 1, T0 + 1000 * i)
        pv = pvote.Vote.decode(rv.encode())
        assert outcome(lambda: pvs.add_vote(pv)) == outcome(lambda: rvs.add_vote(rv))
        assert _tally(pvs) == _tally(rvs)
        assert (pvs.bit_array_by_block_id(port_block_id(win)) or pbits.BitArray(0)).to_bytes() \
            == (rvs.bit_array_by_block_id(win) or rbits.BitArray(0)).to_bytes()
    assert outcome(lambda: pcodec.encode_commit(pvs.make_commit())) == \
        outcome(lambda: rcodec.encode_commit(rvs.make_commit()))
    assert rvs.has_two_thirds_majority() == (nval > 4)
    if nval > 4:
        assert pcodec.encode_commit(pvs.make_commit()) == rcodec.encode_commit(rvs.make_commit())


def test_vote_set_duplicates_conflicts_and_refusals_equal_reference():
    g, keys, rvs, pvs = _vote_sets(5, 50)
    a, b = block_id(g), block_id(g)
    votes = [signed_precommit(keys[0], 0, a, 3, 1, T0),
             signed_precommit(keys[0], 0, a, 3, 1, T0),            # duplicate
             signed_precommit(keys[0], 0, b, 3, 1, T0 + 5),        # equivocation
             signed_precommit(keys[1], 1, a, 4, 1, T0),            # wrong height
             signed_precommit(keys[1], 2, a, 3, 1, T0),            # index/address mismatch
             replace(signed_precommit(keys[1], 1, a, 3, 1, T0), signature=bytes(64)),
             replace(signed_precommit(keys[1], 1, a, 3, 1, T0), validator_index=9),
             signed_precommit(keys[2], 2, a, 3, 1, T0, vote_type=rcanon.PREVOTE_TYPE)]
    for rv in votes:
        pv = pvote.Vote.decode(rv.encode())
        got, want = outcome(lambda: pvs.add_vote(pv)), outcome(lambda: rvs.add_vote(rv))
        assert got == want
        assert _tally(pvs) == _tally(rvs)
    conflict = []
    try:
        pvs.add_vote(pvote.Vote.decode(votes[2].encode()))
    except pvote_set.ConflictingVoteError as exc:
        conflict = [exc.vote_a.encode(), exc.vote_b.encode()]
    assert conflict == [votes[0].encode(), votes[2].encode()]
    # a peer's +2/3 claim for b lets the conflicting vote count for it
    rvs.set_peer_maj23("peer", b)
    pvs.set_peer_maj23("peer", port_block_id(b))
    assert pvs.add_vote(pvote.Vote.decode(votes[2].encode())) == rvs.add_vote(votes[2])
    assert _tally(pvs) == _tally(rvs)
    assert outcome(lambda: pvote_set.VoteSet(CHAIN, 0, 0, 2, pvs.val_set)) == \
        outcome(lambda: rvote_set.VoteSet(CHAIN, 0, 0, 2, rvs.val_set))
