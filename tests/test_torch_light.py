"""The port's light-client verifier (cometbft_tpu_torch/light/verifier.py)
against the reference's (cometbft_tpu/light/verifier.py) on one chain:
10 headers of a 5-validator set that rotates one validator at heights 5
and 9, built with the reference's types from seeded keys, each light
block carried into the port by its header's and commit's wire bytes and
its set's keys and powers.  The reference's own cases
(tests/test_light.py:66-120, there on a running 2-node chain) are
rebuilt on it, with more: every adjacent step, skips across rotations,
trust levels, a wrong next-set hash, a bad signature, a patched clock.
Both packages give the same outcome -- pass, or the same exception
class and message -- and send the same number of signatures per check.

The reference runs with CMT_TPU_DISABLE_DEVICE_VERIFY=1 (its host
verifier, no JAX program compiled), the port with ``device="cpu"``.
Where the port departs on purpose -- a fault of the batch verifier, or
the missing BLS tier, reaches the caller instead of reading as a
rejected header -- the tests say so."""

from dataclasses import replace
from fractions import Fraction
from functools import lru_cache

import pytest

from cometbft_tpu.crypto import dispatch as RD
from cometbft_tpu.light import verifier as rverifier
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types.light_block import LightBlock as RLightBlock
from cometbft_tpu.types.light_block import SignedHeader as RSignedHeader
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.light import verifier as pverifier
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types.light_block import LightBlock as PLightBlock
from cometbft_tpu_torch.types.light_block import SignedHeader as PSignedHeader
from tests.test_torch_types import (
    CHAIN,
    T0,
    outcome,
    port_commit,
    port_header,
    port_val_set,
    ref_commit,
    ref_keys,
    ref_val_set,
    rng,
)
from tests.test_torch_validation import _both, clean  # noqa: F401 -- autouse fixture

HEIGHTS = 10
NVAL = 5
PERIOD = 14 * 24 * 3600 * 10**9
NOW = T0 + 3600 * 10**9          # an hour after the first header


def _header_time(h: int) -> int:
    return T0 + h * 10**9


@lru_cache(maxsize=1)
def chain() -> dict:
    """height -> the reference's LightBlock, 1..HEIGHTS."""
    g = rng(3000)
    keys = ref_keys(g, NVAL + 2)
    active, spare = keys[:NVAL], keys[NVAL:]
    sets = {}
    for h in range(1, HEIGHTS + 2):
        if h in (5, 9):
            active = active[1:] + [spare.pop(0)]
        sets[h] = ref_val_set(active)
    blocks, prev = {}, rblock.BlockID()
    for h in range(1, HEIGHTS + 1):
        vals, ordered = sets[h]
        header = rblock.Header(
            chain_id=CHAIN, height=h, time_ns=_header_time(h), last_block_id=prev,
            last_commit_hash=blocks[h - 1].commit.hash() if h > 1 else b"",
            data_hash=rblock.Data((g.bytes(40),)).hash(), validators_hash=vals.hash(),
            next_validators_hash=sets[h + 1][0].hash(), consensus_hash=g.bytes(32),
            app_hash=g.bytes(32), proposer_address=vals.get_proposer().address)
        bid = rblock.BlockID(hash=header.hash(), part_set_header=rblock.PartSetHeader(
            total=1, hash=g.bytes(32)))
        commit = ref_commit(ordered, bid, h, g, base_ns=header.time_ns + 10**8)
        blocks[h] = RLightBlock(RSignedHeader(header, commit), vals)
        prev = bid
    return blocks


def port_block(lb) -> PLightBlock:
    return PLightBlock(PSignedHeader(port_header(lb.header), port_commit(lb.commit)),
                       port_val_set(lb.validator_set))


def _compare(monkeypatch, fn: str, trusted, untrusted, *args, **kwargs):
    """The same call on both packages -> (outcome, signatures sent per
    batch verifier), equal in both."""
    ref, port = _both(
        monkeypatch,
        lambda: getattr(rverifier, fn)(trusted, untrusted, CHAIN, *args, **kwargs),
        lambda: getattr(pverifier, fn)(port_block(trusted), port_block(untrusted), CHAIN,
                                       *args, device="cpu", **kwargs))
    assert port == ref
    return port


# -- passes ------------------------------------------------------------------

@pytest.mark.parametrize("h", range(1, HEIGHTS))
def test_adjacent_steps_equal_reference(monkeypatch, h):
    """Each step h -> h+1, the rotations at 5 and 9 among them: 4 of 5
    signatures reach the 2/3 (40 > 33) and stop the light check."""
    blocks = chain()
    got = _compare(monkeypatch, "verify_adjacent", blocks[h], blocks[h + 1], PERIOD, NOW)
    assert got == (("ok",), [4])
    assert _compare(monkeypatch, "verify", blocks[h], blocks[h + 1], PERIOD, NOW) == got


@pytest.mark.parametrize("pair", [(1, 3), (1, 8), (2, 10), (4, 9), (1, 10)])
def test_skips_equal_reference(monkeypatch, pair):
    """A skip: the trusted set's 1/3 (16) over the new commit, matched by
    address (2 signatures when both lead the new set's order, more when
    a rotated-in validator comes first), then the new set's own 2/3."""
    blocks = chain()
    a, b = (blocks[h] for h in pair)
    got, sent = _compare(monkeypatch, "verify_non_adjacent", a, b, PERIOD, NOW)
    assert got == ("ok",) and len(sent) == 2 and sent[1] == 4 and 2 <= sent[0] <= 3
    assert _compare(monkeypatch, "verify", a, b, PERIOD, NOW) == (got, sent)


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "expired", "tampered", "future", "not_adjacent", "older", "next_vals_hash", "bad_sig",
    "untrusted_trust", "zero_trust", "trust_above_one", "chain_id"])
def test_refusals_equal_reference(monkeypatch, case):
    blocks = chain()
    lb1, lb2 = blocks[1], blocks[2]
    g = rng(3100)
    fn, trusted, untrusted, args, kwargs = "verify_adjacent", lb1, lb2, (PERIOD, NOW), {}
    if case == "expired":
        args = (1, NOW)
    elif case == "tampered":
        untrusted = replace(lb2, signed_header=RSignedHeader(
            replace(lb2.header, app_hash=b"\xde\xad" * 16), lb2.commit))
    elif case == "future":
        args, kwargs = (PERIOD, lb1.time_ns), {"max_clock_drift_ns": 0}
    elif case == "not_adjacent":
        untrusted = blocks[3]
    elif case == "older":
        fn, trusted, untrusted = "verify_non_adjacent", blocks[4], blocks[2]
    elif case == "next_vals_hash":
        trusted = replace(lb1, signed_header=RSignedHeader(
            replace(lb1.header, next_validators_hash=g.bytes(32)), lb1.commit))
    elif case == "bad_sig":
        sigs = list(lb2.commit.signatures)
        sigs[1] = replace(sigs[1], signature=bytes(64))
        untrusted = replace(lb2, signed_header=RSignedHeader(
            lb2.header, replace(lb2.commit, signatures=tuple(sigs))))
    else:
        fn, untrusted = "verify_non_adjacent", blocks[10]
        kwargs = {"trust_level": {"untrusted_trust": Fraction(9, 10), "zero_trust": Fraction(0),
                                  "trust_above_one": Fraction(3, 2),
                                  "chain_id": Fraction(1, 3)}[case]}
        if case == "chain_id":
            fn = "verify"
            untrusted = replace(untrusted, signed_header=RSignedHeader(
                replace(untrusted.header, chain_id="other-chain"), untrusted.commit))
    got, _ = _compare(monkeypatch, fn, trusted, untrusted, *args, **kwargs)
    assert got[0] == {
        "expired": "ErrOldHeaderExpired", "tampered": "LightBlockError",
        "future": "ErrInvalidHeader", "not_adjacent": "ErrInvalidHeader",
        "older": "ErrInvalidHeader", "next_vals_hash": "ErrInvalidHeader",
        "bad_sig": "ErrInvalidHeader", "untrusted_trust": "ErrNewValSetCantBeTrusted",
        "zero_trust": "ErrNewValSetCantBeTrusted", "trust_above_one": "ErrNewValSetCantBeTrusted",
        "chain_id": "LightBlockError"}[case], got
    if case == "bad_sig":
        assert got[1] == "invalid commit: wrong signature (#1)"


def test_clock_comes_from_now_ns(monkeypatch):
    """``now`` omitted: both read their module's now_ns, patched here to
    a time past the trusting period and then back inside it."""
    blocks = chain()
    for now, want in ((_header_time(3) + PERIOD + 1, "ErrOldHeaderExpired"), (NOW, "ok")):
        monkeypatch.setattr(rverifier, "now_ns", lambda: now)
        monkeypatch.setattr(pverifier, "now_ns", lambda: now)
        got, _ = _compare(monkeypatch, "verify_adjacent", blocks[3], blocks[4], PERIOD)
        assert got[0] == want


# -- the port's departures ---------------------------------------------------

@pytest.mark.parametrize("fn,pair", [("verify_adjacent", (1, 2)), ("verify_non_adjacent", (1, 8))])
def test_batch_verifier_fault_is_not_a_rejected_header(monkeypatch, fn, pair):
    """A RuntimeError of the batch verifier (a kernel that failed to
    build or to launch) reaches the caller as it is; the reference turns
    it into a verdict on the header."""
    def broken(self):
        raise RuntimeError("verify_keyed: CUDA launch failed with error 719")

    monkeypatch.setattr(EV.TorchBatchVerifier, "verify", broken)
    monkeypatch.setattr(RD.LadderHostVerifier, "verify", broken)
    a, b = (chain()[h] for h in pair)
    ref = outcome(lambda: getattr(rverifier, fn)(a, b, CHAIN, PERIOD, NOW))
    assert ref[0] == ("ErrInvalidHeader" if fn == "verify_adjacent"
                      else "ErrNewValSetCantBeTrusted")
    with pytest.raises(RuntimeError, match="error 719"):
        getattr(pverifier, fn)(port_block(a), port_block(b), CHAIN, PERIOD, NOW, device="cpu")


@pytest.mark.parametrize("fn,pair", [("verify_adjacent", (1, 2)), ("verify_non_adjacent", (1, 8))])
def test_device_value_error_is_not_a_rejected_header(monkeypatch, fn, pair):
    """A ValueError of the device layer (here the keyed wrapper refusing
    a pool) is no verdict either: only a CommitError and a bad trust
    level become ErrInvalidHeader or ErrNewValSetCantBeTrusted."""
    def refused(self):
        raise ValueError("verify_keyed: pool too wide for 32-bit limb strides")

    monkeypatch.setattr(EV.TorchBatchVerifier, "verify", refused)
    monkeypatch.setattr(RD.LadderHostVerifier, "verify", refused)
    a, b = (chain()[h] for h in pair)
    ref = outcome(lambda: getattr(rverifier, fn)(a, b, CHAIN, PERIOD, NOW))
    assert ref[0] == ("ErrInvalidHeader" if fn == "verify_adjacent"
                      else "ErrNewValSetCantBeTrusted")
    with pytest.raises(ValueError, match="pool too wide") as err:
        getattr(pverifier, fn)(port_block(a), port_block(b), CHAIN, PERIOD, NOW, device="cpu")
    assert not isinstance(err.value, pverifier.VerificationError)


def test_bls_aggregate_commit_is_not_a_rejected_header():
    """A new header whose commit carries a BLS aggregate: the port cannot
    verify it and says so; it does not reject the header."""
    lb1, lb2 = chain()[1], chain()[2]
    sigs = tuple(replace(cs, signature=b"") for cs in lb2.commit.signatures)
    agg = replace(lb2, signed_header=RSignedHeader(
        lb2.header, replace(lb2.commit, signatures=sigs, agg_signature=bytes(96))))
    with pytest.raises(pvalidation.BlsTierUnavailable):
        pverifier.verify_adjacent(port_block(lb1), port_block(agg), CHAIN, PERIOD, NOW,
                                  device="cpu")
