"""utils/trustguard: the port's wire-provenance guard against the
reference's — the same planted seam -> validator -> sink sequences trip
or pass alike, and the port's seams, validators and sinks are the
reference's (less the RPC ones, not ported yet).

The reference reads its flag at import; it is armed here as its own
tests arm it (``trustguard.reset(enable=True)``), the port's by
``trustguard.enable()``.
"""

import os
import re

import pytest

from cometbft_tpu.utils import trustguard as ref_tg
from cometbft_tpu_torch.utils import trustguard as port_tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the reference's seams the port has no module for yet (RPC)
NOT_PORTED = {
    "seam": {"rpc_tx", "rpc_evidence"},
    "context": {"rpc_tx_async"},
    "validator": set(),
    "sink": set(),
}


@pytest.fixture
def guards():
    ref_tg.reset(enable=True)
    port_tg.reset(enable=True)
    yield ref_tg, port_tg
    ref_tg.install_metrics(None)
    port_tg.install_metrics(None)
    ref_tg.reset(enable=False)
    port_tg.reset(enable=False)


def _names(pkg: str) -> dict:
    pats = {
        "seam": r'guarded_seam\("([\w.]+)"\)',
        "context": r'wire_context\("([\w.]+)"\)',
        "validator": r'note_validated\(\s*"([\w.]+)"\)',
        "sink": r'check_sink\("([\w.]+)"\)',
    }
    out = {k: set() for k in pats}
    root = os.path.join(REPO, pkg)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py") and f != "trustguard.py":
                src = open(os.path.join(d, f)).read()
                for k, pat in pats.items():
                    out[k].update(re.findall(pat, src))
    return out


def test_port_seams_validators_and_sinks_are_the_references():
    ref, port = _names("cometbft_tpu"), _names("cometbft_tpu_torch")
    for kind in ref:
        assert port[kind] <= ref[kind], kind
        assert ref[kind] - port[kind] == NOT_PORTED[kind], kind
    assert port["seam"] == {
        "consensus_state", "consensus_reactor", "blocksync_reactor", "mempool_reactor",
        "evidence_reactor", "statesync_reactor", "statesync_chunk", "pex_reactor",
        "abci_response"}
    assert port["validator"] == {
        "VoteSet._verify", "Part.validate_basic", "verify_commit", "verify_commit_light",
        "verify_commit_light_trusting", "CListMempool._verify_tx_signature",
        "validate_block", "Pool.verify", "Pool.check_evidence"}
    assert port["sink"] == {
        "vote_set.add_vote", "part_set.add_part", "mempool.check_tx", "store.save_block",
        "state.save", "apply_block", "evidence.add"}


def test_the_seam_methods_are_wrapped():
    from cometbft_tpu_torch.blocksync.reactor import BlocksyncReactor
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.consensus.state import ConsensusState
    from cometbft_tpu_torch.evidence.reactor import EvidenceReactor
    from cometbft_tpu_torch.mempool.reactor import MempoolReactor
    from cometbft_tpu_torch.p2p.pex import PexReactor
    from cometbft_tpu_torch.statesync.reactor import StatesyncReactor
    from cometbft_tpu_torch.statesync.syncer import Syncer
    from cometbft_tpu_torch.abci.client import SocketClient

    for fn in (ConsensusState._handle_msg, ConsensusReactor.receive,
               BlocksyncReactor.receive, MempoolReactor.receive, EvidenceReactor.receive,
               StatesyncReactor.receive, Syncer.add_chunk, PexReactor.receive,
               SocketClient._read_response):
        assert hasattr(fn, "__wrapped__"), fn.__qualname__


#: planted sequences: ("seam", name) opens a nested context for the rest,
#: ("ctx", name) opens one and closes it at the matching ("end",),
#: ("ok", validator) notes a validator, ("sink", name) checks a sink
SEQUENCES = [
    [("sink", "store.save_block")],                                # no context: passes
    [("seam", "blocksync_reactor"), ("sink", "store.save_block")],  # trips
    [("seam", "consensus_state"), ("ok", "VoteSet._verify"), ("sink", "vote_set.add_vote")],
    [("seam", "pex_reactor"), ("ok", "verify_commit"), ("ctx", "statesync_chunk"),
     ("sink", "state.save")],                                       # innermost unvalidated
    [("seam", "pex_reactor"), ("ctx", "statesync_chunk"), ("ok", "validate_block"),
     ("end",), ("sink", "apply_block")],                            # validated inner only
    [("ok", "Pool.verify"), ("seam", "evidence_reactor"), ("sink", "evidence.add")],
    [("seam", "mempool_reactor"), ("ok", "CListMempool._verify_tx_signature"),
     ("sink", "mempool.check_tx"), ("sink", "mempool.check_tx")],
]


def _play(tg, seq) -> tuple:
    """-> (outcome, message) of one planted sequence."""

    def run(steps):
        i = 0
        while i < len(steps):
            step = steps[i]
            if step[0] == "seam":
                return tg.guarded_seam(step[1])(lambda: run(steps[i + 1:]))()
            if step[0] == "ctx":
                depth, j = 1, i + 1
                while depth and j < len(steps):
                    depth += {"ctx": 1, "end": -1}.get(steps[j][0], 0)
                    j += 1
                with tg.wire_context(step[1]):
                    run(steps[i + 1:j - 1 if depth == 0 else j])
                i = j
                continue
            if step[0] == "ok":
                tg.note_validated(step[1])
            elif step[0] == "sink":
                tg.check_sink(step[1])
            i += 1
        return None

    try:
        run(seq)
    except tg.TrustGuardError as exc:
        return "trip", str(exc)
    return "pass", ""


@pytest.mark.parametrize("seq", SEQUENCES, ids=[str(i) for i in range(len(SEQUENCES))])
def test_planted_sequences_trip_or_pass_alike(guards, seq):
    from cometbft_tpu.metrics import ConsensusMetrics as RefMetrics
    from cometbft_tpu.utils.metrics import Registry as RefRegistry
    from cometbft_tpu_torch.metrics import ConsensusMetrics
    from cometbft_tpu_torch.utils.metrics import Registry

    ref_reg, port_reg = RefRegistry(), Registry()
    ref_tg.install_metrics(RefMetrics(ref_reg))
    port_tg.install_metrics(ConsensusMetrics(port_reg))
    got_ref, got_port = _play(ref_tg, seq), _play(port_tg, seq)
    assert got_port == got_ref
    trips = [line for line in port_reg.expose().splitlines()
             if line.startswith("cometbft_consensus_trust_guard_trips_total{")]
    ref_trips = [line for line in ref_reg.expose().splitlines()
                 if line.startswith("cometbft_consensus_trust_guard_trips_total{")]
    assert trips == ref_trips and len(trips) == (got_port[0] == "trip")


def test_off_is_inert(guards):
    from cometbft_tpu_torch.metrics import ConsensusMetrics
    from cometbft_tpu_torch.utils.metrics import Registry

    reg = Registry()
    port_tg.install_metrics(ConsensusMetrics(reg))
    port_tg.enable(False)
    assert not port_tg.enabled()
    assert _play(port_tg, SEQUENCES[1]) == ("pass", "")
    assert "trust_guard_trips_total{" not in reg.expose()
    port_tg.enable()
    assert _play(port_tg, SEQUENCES[1])[0] == "trip"
    assert 'cometbft_consensus_trust_guard_trips_total{sink="store.save_block"} 1' in \
        reg.expose()


def _genesis_state(pkg: str):
    import importlib

    ed = importlib.import_module(f"{pkg}.crypto.ed25519")
    genesis = importlib.import_module(f"{pkg}.types.genesis")
    state = importlib.import_module(f"{pkg}.state")
    db = importlib.import_module(f"{pkg}.utils.db")
    gen = genesis.GenesisDoc(chain_id="tg", genesis_time_ns=1, validators=(
        genesis.GenesisValidator(ed.priv_key_from_secret(b"tg").pub_key(), 10),))
    return state.Store(db.MemDB()), state.State.from_genesis(gen)


@pytest.mark.parametrize("pkg", ["cometbft_tpu", "cometbft_tpu_torch"])
def test_a_real_sink_refuses_an_unvalidated_wire_value(guards, pkg):
    tg = port_tg if pkg.endswith("torch") else ref_tg
    store, state = _genesis_state(pkg)
    with pytest.raises(tg.TrustGuardError, match="sink 'state.save'"):
        with tg.wire_context("statesync_reactor"):
            store.save(state)
    assert store.load() is None                      # never mutated
    with tg.wire_context("statesync_reactor"):
        tg.note_validated("verify_commit_light")
        store.save(state)
    assert store.load() is not None
    store.save(state)                                # no context: not checked


def test_a_part_set_sink_behind_a_seam():
    """PartSet.add_part runs Part.validate_basic before its sink, so a
    part behind a seam passes, and a malformed one stops before it."""
    from dataclasses import replace

    from cometbft_tpu_torch.types.part_set import PartSet, PartSetError

    port_tg.reset(enable=True)
    try:
        src = PartSet.from_bytes(b"x" * 300, 100)
        dst = PartSet(src.header)
        seam = port_tg.guarded_seam("consensus_state")
        bad = replace(src.get_part(1), index=2)
        with pytest.raises(PartSetError, match="index mismatch"):
            seam(dst.add_part)(bad)
        assert seam(dst.add_part)(src.get_part(0))
        assert dst.get_part(0) is not None
    finally:
        port_tg.reset(enable=False)
