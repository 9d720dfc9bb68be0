"""The port's commit verification (cometbft_tpu_torch/types/validation.py)
against the reference's (cometbft_tpu/types/validation.py) on the same
commits: each is built with the reference's types from seeded keys and
carried into the port by its wire bytes (tests/test_torch_types.py's
helpers).  Both give the same outcome -- pass, or the same exception
class and message -- and send the same number of signatures to their
batch verifier (the light modes' early break).

The reference runs with CMT_TPU_DISABLE_DEVICE_VERIFY=1: its factory
then hands out its host verifier, so no JAX program is compiled.  The
port runs on ``device="cpu"``: its TorchBatchVerifier's threshold is the
CPU sentinel, so batches take the host tier, except in the case that
patches the factory to ``device_min_batch=0`` and runs the keyed tier's
plain versions.  Where the port departs on purpose -- a BLS aggregate
raises ``BlsTierUnavailable``, a batch verifier's RuntimeError reaches
the caller -- the tests say so.  Every wait is bounded and every queue
stopped in a finally."""

from dataclasses import replace
from fractions import Fraction

import pytest

from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import validation as rvalidation
from cometbft_tpu.types import validator as rvalidator
from cometbft_tpu_torch.crypto import batch as B
from cometbft_tpu_torch.crypto import dispatch as D
from cometbft_tpu_torch.crypto import verify_queue as vq
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import ed25519_verify as EV
from cometbft_tpu_torch.types import validation as pvalidation
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types import vote_set as pvote_set
from cometbft_tpu_torch.utils.flight import FLIGHT
from tests.test_torch_types import (
    CHAIN,
    T0,
    block_id,
    outcome,
    port_block_id,
    port_commit,
    port_val_set,
    ref_commit,
    ref_keys,
    ref_val_set,
    rng,
    signed_precommit,
)

WAIT = 10.0


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.setenv("CMT_TPU_DISABLE_DEVICE_VERIFY", "1")
    D.reset_for_tests()
    yield
    q = vq._QUEUE
    if q is not None and q.is_running():
        q.stop()
    vq.install_queue(None)
    D.reset_for_tests()


class Sent:
    """Wraps a package's batch-verifier factory: every verifier it hands
    out counts the signatures added to it (``sent``, one entry per
    verifier) and is kept (``verifiers``)."""

    def __init__(self, monkeypatch, module, factory=None):
        self.sent: list[int] = []
        self.verifiers: list = []
        real = factory or module.create_batch_verifier

        def counting(pub_key, *args, **kwargs):
            verifier = real(pub_key, *args, **kwargs)
            add, i = verifier.add, len(self.sent)
            self.sent.append(0)
            self.verifiers.append(verifier)

            def add_one(*a):
                self.sent[i] += 1
                return add(*a)

            verifier.add = add_one
            return verifier

        monkeypatch.setattr(module, "create_batch_verifier", counting)


def _both(monkeypatch, run_ref, run_port):
    """(reference outcome, signatures it sent), (port outcome, sent)."""
    from cometbft_tpu.crypto import batch as RB

    with monkeypatch.context() as m:
        rs = Sent(m, RB)
        r = outcome(run_ref)
    with monkeypatch.context() as m:
        ps = Sent(m, B)
        p = outcome(run_port)
    return (r, rs.sent), (p, ps.sent)


def _case(nval: int, tag: int, signers=None, powers=None):
    g = rng(2000 + tag)
    vals, keys = ref_val_set(ref_keys(g, nval), powers)
    bid = block_id(g)
    commit = ref_commit(keys, bid, 1, g, signers=signers)
    return g, vals, keys, bid, commit


MODES = ("full", "light", "light_all", "trusting", "trusting_all")


def _run(mod, mode: str, vals, bid, height: int, commit, trust=Fraction(1, 3), **kw):
    if mode == "full":
        return lambda: mod.verify_commit(CHAIN, vals, bid, height, commit, **kw)
    if mode.startswith("light"):
        return lambda: mod.verify_commit_light(CHAIN, vals, bid, height, commit,
                                               count_all=mode == "light_all", **kw)
    return lambda: mod.verify_commit_light_trusting(CHAIN, vals, commit, trust,
                                                    count_all=mode == "trusting_all", **kw)


def _compare(monkeypatch, mode, vals, bid, height, commit, trust=Fraction(1, 3),
             pvals=None):
    pvals = pvals if pvals is not None else port_val_set(vals)
    ref, port = _both(
        monkeypatch,
        _run(rvalidation, mode, vals, bid, height, commit, trust),
        _run(pvalidation, mode, pvals, port_block_id(bid), height, port_commit(commit),
             trust, device="cpu"))
    assert port == ref
    return port


# -- the reference's own cases (tests/test_types.py:244-325) ------------------

@pytest.mark.parametrize("mode", MODES)
def test_valid_commit_passes_and_sends_as_the_reference(monkeypatch, mode):
    """7 validators of power 10: every signature for verify_commit and
    the count_all modes; the early break stops the light mode at 5
    (50 > 46) and the trusting mode at 3 (30 > 23)."""
    _, vals, _, bid, commit = _case(7, 1)
    got, sent = _compare(monkeypatch, mode, vals, bid, 1, commit)
    assert got == ("ok",)
    assert sent == [{"full": 7, "light": 5, "light_all": 7, "trusting": 3,
                     "trusting_all": 7}[mode]]


@pytest.mark.parametrize("mode", ("full", "light"))
def test_wrong_height_and_block_id_equal_reference(monkeypatch, mode):
    g, vals, _, bid, commit = _case(4, 2)
    got, sent = _compare(monkeypatch, mode, vals, bid, 2, commit)
    assert got[0] == "InvalidCommitHeight" and sent == []
    got, sent = _compare(monkeypatch, mode, vals, block_id(g), 1, commit)
    assert got[0] == "InvalidCommitSignatures" and "wrong block id" in got[1] and sent == []


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bad", [0, 2, 6])
def test_bad_signature_named_as_the_reference(monkeypatch, mode, bad):
    """A zeroed signature: the modes that reach it name its index; the
    light modes' early break may stop before it."""
    _, vals, _, bid, commit = _case(7, 3)
    sigs = list(commit.signatures)
    sigs[bad] = replace(sigs[bad], signature=bytes(64))
    got, _ = _compare(monkeypatch, mode, vals, bid, 1, replace(commit, signatures=tuple(sigs)))
    reaches = mode in ("full", "light_all", "trusting_all") or bad < {"light": 5,
                                                                      "trusting": 3}[mode]
    assert got == (("InvalidCommitSignatures", f"wrong signature (#{bad})") if reaches
                   else ("ok",))


@pytest.mark.parametrize("mode", MODES)
def test_insufficient_power_equals_reference(monkeypatch, mode):
    _, vals, _, bid, commit = _case(4, 4, signers={0, 1})
    got, _ = _compare(monkeypatch, mode, vals, bid, 1, commit)
    assert got[0] == ("NotEnoughVotingPower" if mode in ("full", "light", "light_all")
                      else "ok")


def test_trusting_with_other_sets_equals_reference(monkeypatch):
    """Trusting matches by address: a superset commit verifies against a
    2-validator trusted set (one signature passes the 1/3: a one-signature
    group, verified on its own, no batch verifier); a set of the one
    validator that did not sign has no power behind the commit."""
    _, vals, keys, bid, commit = _case(4, 5, signers={0, 1, 2})
    trusted = rvalidator.ValidatorSet(list(vals.validators[:2]))
    got, sent = _compare(monkeypatch, "trusting", trusted, bid, 1, commit)
    assert got == ("ok",) and sent == []
    got, sent = _compare(monkeypatch, "trusting_all", trusted, bid, 1, commit)
    assert got == ("ok",) and sent == [2]
    absent = rvalidator.ValidatorSet([vals.validators[3]])
    got, _ = _compare(monkeypatch, "trusting", absent, bid, 1, commit)
    assert got[0] == "NotEnoughVotingPower"


@pytest.mark.parametrize("trust", [Fraction(0), Fraction(4, 3), Fraction(2, 3), Fraction(1)])
def test_trust_levels_equal_reference(monkeypatch, trust):
    _, vals, _, bid, commit = _case(6, 6, signers={0, 1, 2, 3, 4})
    got, _ = _compare(monkeypatch, "trusting", vals, bid, 1, commit, trust)
    assert got[0] == {Fraction(0): "ValueError", Fraction(4, 3): "ValueError",
                      Fraction(2, 3): "ok", Fraction(1): "NotEnoughVotingPower"}[trust]


@pytest.mark.parametrize("fault", ["address", "size", "double_vote", "nil_vote", "short_sig"])
def test_malformed_commits_equal_reference(monkeypatch, fault):
    g, vals, keys, bid, commit = _case(5, 7)
    sigs = list(commit.signatures)
    if fault == "address":
        sigs[3] = replace(sigs[3], validator_address=g.bytes(20))
    elif fault == "size":
        sigs = sigs[:4]
    elif fault == "double_vote":
        sigs[4] = sigs[1]
    elif fault == "nil_vote":
        nil = signed_precommit(keys[2], 2, rblock.NIL_BLOCK_ID, 1, 0, T0 + 7)
        sigs[2] = replace(nil.commit_sig(), signature=bytes(64))   # unchecked by light
    else:
        sigs[1] = replace(sigs[1], signature=sigs[1].signature[:63])
    bad = replace(commit, signatures=tuple(sigs))
    for mode in MODES:
        got, _ = _compare(monkeypatch, mode, vals, bid, 1, bad)
        if fault == "short_sig" and mode != "trusting":
            assert got == ("ValueError", "malformed signature size")


# -- the port's own paths ----------------------------------------------------

def test_keyed_plain_path_equals_reference(monkeypatch):
    """The factory patched to the keyed tier's plain versions
    (device_min_batch=0, as tests/test_torch_verify_queue.py does for its
    queue): the same outcomes, answered by the keyed tier.  One mode and
    one key set: the plain table build and the comb of B take most of
    this file's time."""
    mode = "full"
    _, vals, _, bid, commit = _case(6, 8)
    sigs = list(commit.signatures)
    sigs[4] = replace(sigs[4], signature=sigs[4].signature[:40] + b"\x01" + sigs[4].signature[41:])
    bad = replace(commit, signatures=tuple(sigs))
    pvals = port_val_set(vals)
    keyed = lambda pk, device=None: EV.TorchBatchVerifier(device="cpu", device_min_batch=0)  # noqa: E731
    for c, want in ((commit, ("ok",)), (bad, ("InvalidCommitSignatures", "wrong signature (#4)"))):
        ref = outcome(_run(rvalidation, mode, vals, bid, 1, c))
        with monkeypatch.context() as m:
            rec = Sent(m, B, factory=keyed)
            got = outcome(_run(pvalidation, mode, pvals, port_block_id(bid), 1, port_commit(c),
                               device="cpu"))
        assert got == ref == want
        assert [v.last_tier for v in rec.verifiers] == ["keyed"] and rec.sent == [6]


def test_speculative_path_launches_nothing(monkeypatch):
    """Precommits added through VoteSet.add_vote with a queue installed
    land in the speculative cache; verify_commit on make_commit() is then
    all cache hits: no batch verifier is made, no kernel launched, and
    the flight record says tier "speculative"."""
    g = rng(2009)
    vals, keys = ref_val_set(ref_keys(g, 7))
    bid = block_id(g)
    pvals = port_val_set(vals)
    q = vq.VerifyQueue(verifier_factory=lambda pk: B.create_batch_verifier(pk, device="cpu"))
    q.start()
    vq.install_queue(q)
    try:
        vs = pvote_set.VoteSet(CHAIN, 1, 0, 2, pvals)
        for i, k in enumerate(keys):
            rv = signed_precommit(k, i, bid, 1, 0, T0 + int(g.integers(0, 10**9)))
            assert vs.add_vote(pvote.Vote.decode(rv.encode()))
        commit = vs.make_commit()
        launches = dict(_build.LAUNCHES)
        with monkeypatch.context() as m:
            rec = Sent(m, B)
            pvalidation.verify_commit(CHAIN, pvals, port_block_id(bid), 1, commit, device="cpu")
        record = [e for e in FLIGHT.tail(5) if e["kind"] == "consensus/speculative_verify"][-1]
        assert rec.sent == [] and dict(_build.LAUNCHES) == launches
        assert (record["hits"], record["misses"], record["tier"]) == (7, 0, "speculative")
        # the reference's verdict on the same commit, carried back
        from cometbft_tpu.types import codec as rcodec
        from cometbft_tpu_torch.types import codec as pcodec

        assert outcome(lambda: rvalidation.verify_commit(
            CHAIN, vals, bid, 1, rcodec.decode_commit(pcodec.encode_commit(commit)))) == ("ok",)
    finally:
        q.stop()
    assert vq._QUEUE is None


def test_bls_aggregate_commit_raises_the_typed_error(monkeypatch):
    """A commit whose COMMIT entries are covered by a BLS aggregate:
    nothing is verified and no verdict is given (not a CommitError)."""
    _, vals, _, bid, commit = _case(5, 10)
    sigs = tuple(replace(cs, signature=b"") if i != 3 else cs
                 for i, cs in enumerate(commit.signatures))
    agg = port_commit(replace(commit, signatures=sigs, agg_signature=bytes(range(96))))
    pvals = port_val_set(vals)
    for mode in MODES:
        with monkeypatch.context() as m:
            rec = Sent(m, B)
            with pytest.raises(pvalidation.BlsTierUnavailable, match="no BLS tier") as err:
                _run(pvalidation, mode, pvals, port_block_id(bid), 1, agg, device="cpu")()
        assert rec.sent == [] and not isinstance(err.value, pvalidation.CommitError)
        assert isinstance(err.value, NotImplementedError)


@pytest.mark.parametrize("mode", MODES)
def test_aggregate_covering_nothing_equals_reference(monkeypatch, mode):
    """An aggregate signature beside votes that all carry their own: the
    commit is malformed, the same verdict in both packages, and nothing
    is sent to a batch verifier."""
    _, vals, _, bid, commit = _case(4, 13)
    got, sent = _compare(monkeypatch, mode, vals, bid, 1,
                         replace(commit, agg_signature=bytes(range(96))))
    assert got == ("InvalidCommitSignatures",
                   "aggregate signature with no aggregated signatures")
    assert sent == []


def test_batch_verifier_fault_reaches_the_caller(monkeypatch):
    """A RuntimeError of the batch verifier (a kernel that failed to
    build or to launch) is not a verdict: it reaches verify_commit's
    caller as it is."""
    _, vals, _, bid, commit = _case(4, 11)

    def broken(self):
        raise RuntimeError("verify_keyed: CUDA launch failed with error 719")

    monkeypatch.setattr(EV.TorchBatchVerifier, "verify", broken)
    for mode in MODES:
        with pytest.raises(RuntimeError, match="error 719"):
            _run(pvalidation, mode, port_val_set(vals), port_block_id(bid), 1,
                 port_commit(commit), device="cpu")()


def test_device_defaults_to_cuda(monkeypatch):
    """No ``device``: the factory is asked for the card, and without one
    it raises (no silent CPU verify)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, vals, _, bid, commit = _case(4, 12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pvalidation.verify_commit(CHAIN, port_val_set(vals), port_block_id(bid), 1,
                                  port_commit(commit))
