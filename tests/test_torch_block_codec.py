"""The rest of the port's types layer (cometbft_tpu_torch/types/{part_set,
evidence,block_meta,params,genesis,light_block}.py, ``Block``'s part set,
encoding and hashes, and the evidence, block, proof and part codecs of
types/codec.py) against the reference's (cometbft_tpu/types/...), which
imports no jax for these modules.

Each case builds its inputs with the reference's types from a seed and
carries them into the port by their wire bytes (tests/test_torch_types.py's
``port_header``, ``port_commit`` and ``port_val_set``; votes by
``Vote.decode``; a proposer-rotated set by the port's validator-set
codec).  Tolerance: byte for byte -- encodings in both directions,
hashes, merkle roots and proofs, JSON; a refusal is the same exception
class with the same message."""

import json
from dataclasses import replace

import pytest

from cometbft_tpu.crypto import merkle as rmerkle
from cometbft_tpu.state import decode_validator_set as r_decode_vals
from cometbft_tpu.state import encode_validator_set as r_encode_vals
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import block_meta as rmeta
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types import evidence as revidence
from cometbft_tpu.types import genesis as rgenesis
from cometbft_tpu.types import params as rparams
from cometbft_tpu.types import part_set as rparts
from cometbft_tpu.types.light_block import LightBlock as RLightBlock
from cometbft_tpu.types.light_block import SignedHeader as RSignedHeader
from cometbft_tpu_torch.crypto import ed25519 as ped
from cometbft_tpu_torch.crypto import merkle as pmerkle
from cometbft_tpu_torch.state import decode_validator_set as p_decode_vals
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import block_meta as pmeta
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.types import evidence as pevidence
from cometbft_tpu_torch.types import genesis as pgenesis
from cometbft_tpu_torch.types import params as pparams
from cometbft_tpu_torch.types import part_set as pparts
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.light_block import LightBlock as PLightBlock
from cometbft_tpu_torch.types.light_block import SignedHeader as PSignedHeader
from tests.test_torch_types import (
    CHAIN,
    T0,
    block_id,
    outcome,
    port_block_id,
    port_commit,
    port_header,
    port_val_set,
    random_header,
    ref_commit,
    ref_keys,
    ref_val_set,
    rng,
    signed_precommit,
)


# -- carrying reference values into the port ---------------------------------

def port_vals(ref_vals):
    """A reference set through the port's validator-set codec: members,
    priorities and the proposer, as a node's store carries them."""
    return p_decode_vals(r_encode_vals(ref_vals))


def port_vote(vote) -> pvote.Vote:
    return pvote.Vote.decode(vote.encode())


def port_light_block(lb) -> PLightBlock:
    return PLightBlock(PSignedHeader(port_header(lb.header), port_commit(lb.commit)),
                       port_vals(lb.validator_set))


def port_evidence(ev):
    if isinstance(ev, revidence.DuplicateVoteEvidence):
        return pevidence.DuplicateVoteEvidence(
            vote_a=port_vote(ev.vote_a), vote_b=port_vote(ev.vote_b),
            total_voting_power=ev.total_voting_power, validator_power=ev.validator_power,
            timestamp_ns=ev.timestamp_ns)
    return pevidence.LightClientAttackEvidence(
        conflicting_block=port_light_block(ev.conflicting_block),
        common_height=ev.common_height, byzantine_validators=ev.byzantine_validators,
        total_voting_power=ev.total_voting_power, timestamp_ns=ev.timestamp_ns)


def port_block(b) -> pblock.Block:
    return pblock.Block(
        header=port_header(b.header), data=pblock.Data(txs=tuple(b.data.txs)),
        evidence=tuple(port_evidence(ev) for ev in b.evidence),
        last_commit=port_commit(b.last_commit) if b.last_commit is not None else None)


# -- reference inputs ----------------------------------------------------------

def light_block(g, nval: int = 4, height: int = 7, header=None):
    """(a reference LightBlock whose commit signs its header, its keys)."""
    vals, keys = ref_val_set(ref_keys(g, nval))
    vals = vals.increment_proposer_priority(int(g.integers(1, 5)))
    keys = sorted(keys, key=lambda k: [v.address for v in vals.validators].index(
        k.pub_key().address()))
    header = header or replace(random_header(g, height), validators_hash=vals.hash(),
                               proposer_address=vals.get_proposer().address)
    bid = rblock.BlockID(hash=header.hash(), part_set_header=rblock.PartSetHeader(
        total=1, hash=g.bytes(32)))
    return RLightBlock(RSignedHeader(header, ref_commit(keys, bid, header.height, g)), vals), keys


def duplicate_vote(g, vals=None, keys=None):
    if vals is None:
        vals, keys = ref_val_set(ref_keys(g, 4))
    k = int(g.integers(0, len(keys)))
    a = signed_precommit(keys[k], k, block_id(g), 9, 0, T0 + 1)
    b = signed_precommit(keys[k], k, block_id(g), 9, 0, T0 + 2)
    return revidence.DuplicateVoteEvidence.from_votes(a, b, T0 + 5, vals)


def attack(g):
    lb, _ = light_block(g)
    return revidence.LightClientAttackEvidence(
        conflicting_block=lb, common_height=5,
        byzantine_validators=tuple(v.address for v in lb.validator_set.validators[:2]),
        total_voting_power=lb.validator_set.total_voting_power(), timestamp_ns=T0 + 9)


def ref_block(g, ntx: int, nev: int, last: bool):
    evidence = tuple(duplicate_vote(g) if i % 2 == 0 else attack(g) for i in range(nev))
    last_commit = None
    if last:
        vals, keys = ref_val_set(ref_keys(g, 5))
        last_commit = ref_commit(keys, block_id(g), 6, g)
    txs = tuple(g.bytes(int(g.integers(1, 300))) for _ in range(ntx))
    return rblock.Block(header=random_header(g, 7), data=rblock.Data(txs=txs),
                        evidence=evidence, last_commit=last_commit)


# -- blocks --------------------------------------------------------------------

@pytest.mark.parametrize("ntx,nev,last", [(0, 0, False), (3, 0, True), (12, 2, True),
                                          (40, 3, False)])
def test_block_encoding_hashes_and_part_set_equal_reference(ntx, nev, last):
    g = rng(4000 + ntx)
    rb = ref_block(g, ntx, nev, last)
    pb = port_block(rb)
    assert pb.encode() == rb.encode() == pcodec.encode_block(pb)
    assert pcodec.decode_block(rb.encode()).encode() == rb.encode()
    rh, ph = rb.with_hashes(), pb.with_hashes()
    assert pcodec.encode_header(ph.header) == rcodec.encode_header(rh.header)
    assert ph.hash() == rh.hash() and ph.header.data_hash == rh.header.data_hash
    assert ph.header.evidence_hash == rh.header.evidence_hash
    for size in (64, 1000, rparts.BLOCK_PART_SIZE_BYTES):
        rps, pps = rh.make_part_set(size), ph.make_part_set(size)
        assert (pps.header.total, pps.header.hash) == (rps.header.total, rps.header.hash)
        assert pps.byte_size == rps.byte_size and pps.is_complete()
        assert pps.assemble() == rps.assemble() == ph.encode()


def test_block_decode_round_trips_reference_bytes():
    """A block with every kind of content, decoded by the port from the
    reference's bytes: the same txs, evidence and last commit."""
    g = rng(4010)
    rb = ref_block(g, 5, 2, True).with_hashes()
    pb = pcodec.decode_block(rcodec.encode_block(rb))
    assert pb.data.txs == rb.data.txs and len(pb.evidence) == 2
    assert [pcodec.encode_evidence(e) for e in pb.evidence] == \
        [rcodec.encode_evidence(e) for e in rb.evidence]
    assert pcodec.encode_commit(pb.last_commit) == rcodec.encode_commit(rb.last_commit)
    assert pb.hash() == rb.hash()


# -- part sets, proofs and parts -------------------------------------------------

@pytest.mark.parametrize("size,part", [(0, 64), (1, 64), (64, 64), (65, 64), (1000, 7),
                                       (5000, 1024), (70000, 65536)])
def test_part_set_roots_proofs_and_codecs_equal_reference(size, part):
    data = rng(4100 + size).bytes(size)
    rps, pps = rparts.PartSet.from_bytes(data, part), pparts.PartSet.from_bytes(data, part)
    assert (pps.header.total, pps.header.hash) == (rps.header.total, rps.header.hash)
    assert pps.parts_bit_array.to_bytes() == rps.parts_bit_array.to_bytes()
    for i in range(rps.header.total):
        rp, pp = rps.get_part(i), pps.get_part(i)
        assert pcodec.encode_proof(pp.proof) == rcodec.encode_proof(rp.proof)
        assert pcodec.encode_part(pp) == rcodec.encode_part(rp)
        back = pcodec.decode_part(rcodec.encode_part(rp))
        assert back == pp and pcodec.decode_proof(rcodec.encode_proof(rp.proof)) == pp.proof
        assert pp.proof.verify(pps.header.hash, pp.bytes)
    # a receiver assembling the parts out of order, with a duplicate
    rrx, prx = rparts.PartSet(rps.header), pparts.PartSet(pps.header)
    order = rng(4150 + size).permutation(rps.header.total).tolist()
    for i in order + order[:1]:
        assert prx.add_part(pps.get_part(i)) == rrx.add_part(rps.get_part(i))
        assert (prx.count, prx.byte_size, prx.is_complete()) == \
            (rrx.count, rrx.byte_size, rrx.is_complete())
    assert prx.assemble() == rrx.assemble() == data


@pytest.mark.parametrize("case", ["negative", "proof_index", "too_large", "out_of_range",
                                  "bad_proof", "total_mismatch", "incomplete", "total_range"])
def test_part_set_refusals_equal_reference(case):
    data = rng(4200).bytes(300)

    def run(mod, codec_mod, merkle_mod):
        ps = mod.PartSet.from_bytes(data, 100)
        part = ps.get_part(1)
        rx = mod.PartSet(ps.header)
        if case == "negative":
            return lambda: rx.add_part(replace(part, index=-1))
        if case == "proof_index":
            return lambda: rx.add_part(replace(part, index=2))
        if case == "too_large":
            big = mod.Part(index=0, bytes=bytes(mod.BLOCK_PART_SIZE_BYTES + 1),
                           proof=ps.get_part(0).proof)
            return lambda: rx.add_part(big)
        if case == "out_of_range":
            proof = replace(part.proof, index=7)
            return lambda: rx.add_part(mod.Part(index=7, bytes=part.bytes, proof=proof))
        if case == "bad_proof":
            return lambda: rx.add_part(replace(part, bytes=part.bytes[:-1] + b"\x00"))
        if case == "total_mismatch":
            wide = mod.PartSet(replace(ps.header, total=ps.header.total + 1))
            return lambda: wide.add_part(part)
        if case == "incomplete":
            rx.add_part(part)
            return rx.assemble
        return lambda: mod.PartSet(replace(ps.header, total=mod.MAX_PART_SET_TOTAL + 1))

    ref = outcome(run(rparts, rcodec, rmerkle))
    assert ref[0] == "PartSetError"
    assert outcome(run(pparts, pcodec, pmerkle)) == ref


# -- evidence ------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(3))
def test_duplicate_vote_evidence_equals_reference(trial):
    g = rng(4300 + trial)
    vals, keys = ref_val_set(ref_keys(g, 4))
    rev = duplicate_vote(g, vals, keys)
    pev = pevidence.DuplicateVoteEvidence.from_votes(
        port_vote(rev.vote_b), port_vote(rev.vote_a), T0 + 5, port_val_set(vals))
    assert pcodec.encode_evidence(pev) == rcodec.encode_evidence(rev)
    assert pev.hash() == rev.hash() and pev.height == rev.height
    assert pcodec.encode_evidence(pcodec.decode_evidence(rcodec.encode_evidence(rev))) == \
        rcodec.encode_evidence(rev)
    pev.validate_basic()
    swapped_r = replace(rev, vote_a=rev.vote_b, vote_b=rev.vote_a)
    swapped_p = replace(pev, vote_a=pev.vote_b, vote_b=pev.vote_a)
    assert outcome(swapped_p.validate_basic) == outcome(swapped_r.validate_basic) == \
        ("EvidenceError", "duplicate votes in wrong order")
    stranger = signed_precommit(ref_keys(g, 1)[0], 0, block_id(g), 9, 0, T0)
    assert outcome(lambda: pevidence.DuplicateVoteEvidence.from_votes(
        port_vote(stranger), port_vote(rev.vote_b), 0, port_val_set(vals))) == outcome(
        lambda: revidence.DuplicateVoteEvidence.from_votes(stranger, rev.vote_b, 0, vals)) == \
        ("EvidenceError", "validator not in set")


@pytest.mark.parametrize("kind", ["lunatic", "equivocation", "amnesia"])
def test_light_client_attack_evidence_equals_reference(kind):
    """hash (header hash and common height only), codec, the lunatic test
    and the byzantine validators of each attack kind."""
    g = rng(4400 + len(kind))
    trusted, keys = light_block(g, nval=6)
    header = trusted.header
    if kind == "lunatic":
        header = replace(header, app_hash=g.bytes(32))
    else:
        header = replace(header, data_hash=g.bytes(32))
    bid = rblock.BlockID(hash=header.hash(), part_set_header=trusted.commit.block_id
                         .part_set_header)
    signers = {0, 2, 3, 5}
    commit = ref_commit(keys, bid, header.height, g, signers=signers,
                        round_=1 if kind == "amnesia" else 0)
    conflicting = RLightBlock(RSignedHeader(header, commit), trusted.validator_set)
    common_vals, _ = ref_val_set(keys[1:])
    rev = revidence.LightClientAttackEvidence(
        conflicting_block=conflicting, common_height=header.height - 2,
        total_voting_power=common_vals.total_voting_power(), timestamp_ns=T0 + 3)
    pev = port_evidence(rev)
    psh = PSignedHeader(port_header(trusted.header), port_commit(trusted.commit))
    assert pev.conflicting_header_is_invalid(psh.header) == \
        rev.conflicting_header_is_invalid(trusted.header) == (kind == "lunatic")
    rbyz = rev.get_byzantine_validators(common_vals, trusted.signed_header)
    pbyz = pev.get_byzantine_validators(port_val_set(common_vals), psh)
    assert [(v.address, v.voting_power) for v in pbyz] == \
        [(v.address, v.voting_power) for v in rbyz]
    assert len(rbyz) == {"lunatic": 3, "equivocation": 4, "amnesia": 0}[kind]
    rev = replace(rev, byzantine_validators=tuple(v.address for v in rbyz))
    pev = replace(pev, byzantine_validators=tuple(v.address for v in pbyz))
    assert pcodec.encode_evidence(pev) == rcodec.encode_evidence(rev)
    assert pev.hash() == rev.hash() and pev.conflicting_header_hash == \
        rev.conflicting_header_hash and pev.height == rev.height
    back = pcodec.decode_evidence(rcodec.encode_evidence(rev))
    assert pcodec.encode_evidence(back) == rcodec.encode_evidence(rev)


# -- light blocks, block metas, params, genesis --------------------------------

@pytest.mark.parametrize("nval", [1, 4, 9])
def test_light_block_and_signed_header_codec_equal_reference(nval):
    rlb, _ = light_block(rng(4500 + nval), nval=nval)
    plb = port_light_block(rlb)
    assert plb.encode() == rlb.encode()
    assert plb.signed_header.encode() == rlb.signed_header.encode()
    back = PLightBlock.decode(rlb.encode())
    assert back.encode() == rlb.encode() and back.hash() == rlb.hash()
    assert back.validator_set.get_proposer().address == \
        rlb.validator_set.get_proposer().address
    assert PSignedHeader.decode(rlb.signed_header.encode()).hash() == rlb.signed_header.hash()
    back.validate_basic(CHAIN)
    rlb.validate_basic(CHAIN)


@pytest.mark.parametrize("ntx", [0, 7])
def test_block_meta_equals_reference(ntx):
    rb = ref_block(rng(4600 + ntx), ntx, 0, True).with_hashes()
    pb = port_block(rb)
    rm = rmeta.BlockMeta.from_parts(rb, rb.make_part_set(256))
    pm = pmeta.BlockMeta.from_parts(pb, pb.make_part_set(256))
    assert pm.encode() == rm.encode() and pm.num_txs == ntx
    back = pmeta.BlockMeta.decode(rm.encode())
    assert back.encode() == rm.encode() and back.block_id == port_block_id(rm.block_id)
    assert pmeta.BlockMeta.decode(b"").encode() == rmeta.BlockMeta.decode(b"").encode()


def _params(mod, g):
    return mod.ConsensusParams(
        block=mod.BlockParams(max_bytes=int(g.integers(1, 1 << 26)),
                              max_gas=int(g.integers(-1, 1 << 40))),
        evidence=mod.EvidenceParams(max_age_num_blocks=int(g.integers(1, 10**6)),
                                    max_age_duration_ns=int(g.integers(1, 10**15)),
                                    max_bytes=int(g.integers(0, 1 << 21))),
        validator=mod.ValidatorParams(pub_key_types=("ed25519",)),
        feature=mod.FeatureParams(vote_extensions_enable_height=int(g.integers(0, 100)),
                                  pbts_enable_height=int(g.integers(0, 100))),
        synchrony=mod.SynchronyParams(precision_ns=int(g.integers(1, 10**9)),
                                      message_delay_ns=int(g.integers(1, 10**10))))


@pytest.mark.parametrize("trial", range(4))
def test_consensus_params_hash_and_json_equal_reference(trial):
    g = rng(4700 + trial)
    rp = _params(rparams, g) if trial else rparams.DEFAULT_CONSENSUS_PARAMS
    pp = pparams.ConsensusParams.from_json_dict(json.loads(json.dumps(rp.to_json_dict())))
    assert pp.to_json_dict() == rp.to_json_dict() and pp.hash() == rp.hash()
    assert pparams.ConsensusParams.from_json_dict({}).hash() == \
        rparams.ConsensusParams.from_json_dict({}).hash()
    for h in (0, 1, 50, 99):
        assert pp.vote_extensions_enabled(h) == rp.vote_extensions_enabled(h)
        assert pp.pbts_enabled(h) == rp.pbts_enabled(h)


@pytest.mark.parametrize("bad", [dict(max_bytes=0), dict(max_bytes=-2),
                                 dict(max_bytes=rparams.MAX_BLOCK_SIZE_BYTES + 1),
                                 dict(max_gas=-2), dict(age=0), dict(duration=0),
                                 dict(key_types=())])
def test_consensus_params_refusals_equal_reference(bad):
    def make(mod):
        p = mod.ConsensusParams()
        if "age" in bad:
            p = replace(p, evidence=replace(p.evidence, max_age_num_blocks=bad["age"]))
        elif "duration" in bad:
            p = replace(p, evidence=replace(p.evidence, max_age_duration_ns=bad["duration"]))
        elif "key_types" in bad:
            p = replace(p, validator=mod.ValidatorParams(pub_key_types=bad["key_types"]))
        else:
            p = replace(p, block=replace(p.block, **bad))
        return p.validate

    ref = outcome(make(rparams))
    assert ref[0] == "ValueError" and outcome(make(pparams)) == ref


def _genesis(mod, keys, g, **kw):
    key_type = ped.Ed25519PubKey if mod is pgenesis else type(keys[0].pub_key())
    vals = tuple(mod.GenesisValidator(pub_key=key_type(k.pub_key().bytes()),
                                      power=int(g.integers(1, 100)), name=f"val-{i}")
                 for i, k in enumerate(keys))
    args = dict(chain_id=CHAIN, genesis_time_ns=T0, initial_height=3, validators=vals,
                app_hash=bytes(range(32)), app_state=b'{"accounts": [1, 2]}')
    args.update(kw)
    return mod.GenesisDoc(**args)


def test_genesis_doc_json_hash_and_file_equal_reference(tmp_path):
    keys = ref_keys(rng(4800), 5)
    rdoc, pdoc = _genesis(rgenesis, keys, rng(4801)), _genesis(pgenesis, keys, rng(4801))
    assert pdoc.to_json() == rdoc.to_json() and pdoc.hash() == rdoc.hash()
    assert pdoc.validator_set().hash() == rdoc.validator_set().hash()
    assert pgenesis.GenesisDoc.from_json(rdoc.to_json()).to_json() == rdoc.to_json()
    pdoc.save_as(str(tmp_path / "port.json"))
    assert rgenesis.GenesisDoc.from_file(str(tmp_path / "port.json")).to_json() == rdoc.to_json()
    rdoc.save_as(str(tmp_path / "ref.json"))
    assert pgenesis.GenesisDoc.from_file(str(tmp_path / "ref.json")).hash() == rdoc.hash()


@pytest.mark.parametrize("case", ["no_chain", "long_chain", "height", "power", "key_type",
                                  "params"])
def test_genesis_refusals_equal_reference(case):
    keys = ref_keys(rng(4900), 2)

    def run(mod):
        params = rparams if mod is rgenesis else pparams
        if case == "key_type":
            raw = json.loads(_genesis(mod, keys, rng(4901)).to_json())
            raw["validators"][0]["pub_key"]["type"] = "tendermint/PubKeySecp256k1"
            return lambda: mod.GenesisDoc.from_json(json.dumps(raw))
        kw = {"no_chain": dict(chain_id=""), "long_chain": dict(chain_id="c" * 51),
              "height": dict(initial_height=0), "power": {},
              "params": dict(consensus_params=replace(
                  params.ConsensusParams(), block=params.BlockParams(max_bytes=0)))}[case]
        doc = _genesis(mod, keys, rng(4901), **kw)
        if case == "power":
            doc = replace(doc, validators=(replace(doc.validators[0], power=-1),))
        return doc.validate_and_complete

    ref = outcome(run(rgenesis))
    assert ref[0] in ("GenesisError", "ValueError") and outcome(run(pgenesis)) == ref


# -- decode refusals -----------------------------------------------------------

def _ld(field: int, payload: bytes) -> bytes:
    from cometbft_tpu.utils.protoio import ProtoWriter

    w = ProtoWriter()
    w.bytes_(field, payload)
    return w.finish()


def _vi(field: int, value: int) -> bytes:
    from cometbft_tpu.utils.protoio import ProtoWriter

    w = ProtoWriter()
    w.varint(field, value)
    return w.finish()


@pytest.mark.parametrize("what,data", [
    ("decode_evidence", b""),
    ("decode_evidence", _ld(2, _vi(3, 5))),
    ("decode_evidence", _vi(1, 7)),
    ("decode_block", b""),
    ("decode_block", _vi(1, 1 << 40)),
    ("decode_block", _ld(1, b"") + _vi(2, 3)),
    ("decode_part", _vi(3, 9)),
    ("decode_part", _ld(3, b"") + _vi(2, 1 << 50)),
    ("decode_proof", _ld(2, b"x")),
    ("decode_proof", _vi(4, 1 << 30)),
    ("block_meta", _ld(2, b"x")),
    ("light_block", b""),
    ("light_block", _ld(1, b"") + _ld(2, _ld(1, _ld(1, _ld(1, b"secp256k1"))))),
])
def test_decode_refusals_equal_reference(what, data):
    """Malformed wire bytes: the same exception class and message."""
    def run(codec_mod, meta_mod, lb_cls):
        if what == "block_meta":
            return lambda: meta_mod.BlockMeta.decode(data)
        if what == "light_block":
            return lambda: lb_cls.decode(data)
        return lambda: getattr(codec_mod, what)(data)

    ref = outcome(run(rcodec, rmeta, RLightBlock))
    assert ref[0] != "ok"
    assert outcome(run(pcodec, pmeta, PLightBlock)) == ref


def test_validator_set_codec_equals_reference():
    """The set codec the light block and the state store share: members,
    priorities and the proposer by address."""
    g = rng(4950)
    vals, _ = ref_val_set(ref_keys(g, 7), [int(g.integers(1, 50)) for _ in range(7)])
    vals = vals.increment_proposer_priority(3)
    from cometbft_tpu_torch.state import encode_validator_set

    pv = port_vals(vals)
    assert encode_validator_set(pv) == r_encode_vals(vals)
    assert pv.get_proposer().address == vals.get_proposer().address
    assert r_decode_vals(encode_validator_set(pv)).hash() == vals.hash()
