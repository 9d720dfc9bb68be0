"""The port's light client (cometbft_tpu_torch/light/{client,provider,
store}.py) against the reference's (cometbft_tpu/light/...), each over its
own package's block and state stores holding one chain: 16 heights of 7
validators in which an original validator leaves and a newcomer joins at
every other height's set while more than one original is left
(tests/test_torch_store.py's ``chain``), so height 1's set holds 1 of 7
of height 16's power and the skipping sync must bisect (1 -> 8 -> 16).

Cases: skipping with bisection, sequential, backwards, an expired trust
root, a height the primary lacks, a flipped signature in a third store,
honest, lagging and unreachable witnesses, and a forked witness (a
conflicting top block with another app_hash, signed by the same keys).
Both packages give the same outcome -- pass, or the same exception class
and message -- leave the same trusted heights in the LightStore, send the
same signatures per check, and report evidence of the same bytes to the
same providers.

The reference runs with CMT_TPU_DISABLE_DEVICE_VERIFY=1 (its host
verifier, no JAX program compiled), the port with ``device="cpu"``.
Where the port departs on purpose -- an exception from a witness other
than a ProviderError reaches the caller -- the test says so."""

from dataclasses import replace

import pytest

from cometbft_tpu.crypto import batch as RB
from cometbft_tpu.light import client as rclient
from cometbft_tpu.light import provider as rprovider
from cometbft_tpu.light import store as rlight_store
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.utils import db as rdb
from cometbft_tpu_torch.crypto import batch as B
from cometbft_tpu_torch.light import client as pclient
from cometbft_tpu_torch.light import provider as pprovider
from cometbft_tpu_torch.light import store as plight_store
from cometbft_tpu_torch.store import BlockStore as PBlockStore
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.utils import db as pdb
from tests.test_torch_store import BLOCK_NS, PART, chain, fill, port_commit, port_parts
from tests.test_torch_types import CHAIN, T0, outcome, signed_precommit
from tests.test_torch_validation import Sent, clean  # noqa: F401 -- autouse fixture

SHAPE = dict(heights=16, nval=7, every=2, keep=1, tag=1)
TOP = SHAPE["heights"]
PERIOD = 14 * 24 * 3600 * 10**9
NOW = T0 + 100 * BLOCK_NS


class Recording:
    """Wraps a provider: keeps the evidence it is sent, and can stand for
    a witness that fails (``fail``: an exception to raise on every
    light_block)."""

    def __init__(self, inner, fail=None) -> None:
        self.inner, self.fail, self.reported = inner, fail, []

    def chain_id(self) -> str:
        return self.inner.chain_id()

    def light_block(self, height: int):
        if self.fail is not None:
            raise self.fail
        return self.inner.light_block(height)

    def report_evidence(self, ev) -> None:
        self.reported.append(ev)


def _copy(db_mod, src):
    out = db_mod.MemDB()
    out.write_batch(list(src.iterator()))
    return out


def forked_top():
    """The chain's top block again with another app_hash, signed by the
    same validators: (block, part set, commit), the reference's."""
    gen, blocks, keys = chain(**SHAPE)
    prev_state, last_commit = blocks[-2][3], blocks[-2][2]
    block = blocks[-1][0]
    block = replace(block, header=replace(block.header, app_hash=b"\x0f" * 32)).with_hashes()
    parts = block.make_part_set(PART)
    bid = rblock.BlockID(hash=block.hash(), part_set_header=parts.header)
    t = block.header.time_ns + BLOCK_NS // 2
    sigs = tuple(signed_precommit(keys[v.address], i, bid, TOP, 0, t + i).commit_sig()
                 for i, v in enumerate(prev_state.next_validators.validators))
    assert prev_state.next_validators.hash() == block.header.validators_hash
    return block, parts, rblock.Commit(height=TOP, round=0, block_id=bid, signatures=sigs)


def flipped_commit(height: int):
    """The canonical commit for ``height`` with signature #0's byte 40
    flipped, as both packages encode it."""
    commit = chain(**SHAPE)[1][height - 1][2]
    cs = commit.signatures[0]
    bad = cs.signature[:40] + bytes([cs.signature[40] ^ 1]) + cs.signature[41:]
    return rcodec.encode_commit(replace(commit, signatures=(replace(cs, signature=bad),)
                                        + commit.signatures[1:]))


def providers(side: dict, mods, kind: str, db_mod, store_cls, codec_mod):
    """(primary, witnesses) for one package over its filled stores."""
    node = mods.NodeProvider
    primary = Recording(node(CHAIN, side["blocks"], side["states"]))
    if kind == "bad_sig":
        bdb = _copy(db_mod, side["bdb"])
        bdb.set(b"C:" + (TOP // 2).to_bytes(8, "big"), flipped_commit(TOP // 2))
        primary = Recording(node(CHAIN, store_cls(bdb), side["states"]))
    witnesses = []
    if kind in ("honest_witness", "forked_witness", "lagging_witness", "down_witness"):
        bdb = _copy(db_mod, side["bdb"])
        store = store_cls(bdb)
        if kind == "forked_witness":
            block, parts, commit = forked_top()
            store.prune_last_block()
            if codec_mod is pcodec:
                store.save_block(pcodec.decode_block(block.encode()), port_parts(block),
                                 port_commit(commit))
            else:
                store.save_block(block, parts, commit)
        if kind == "lagging_witness":
            store.prune_last_block()
        fail = mods.ProviderError("witness unreachable") if kind == "down_witness" else None
        witnesses.append(Recording(node(CHAIN, store, side["states"]), fail=fail))
    return primary, witnesses


CASES = {
    # case: (mode, trust height, period, action, target)
    "skipping": ("skipping", 1, PERIOD, "update", None),
    "sequential": ("sequential", 1, PERIOD, "at", 10),
    "backwards": ("skipping", TOP, PERIOD, "at", 11),
    "expired": ("skipping", 1, BLOCK_NS, "update", None),
    "missing": ("skipping", 1, PERIOD, "at", TOP + 4),
    "bad_sig": ("skipping", 1, PERIOD, "update", None),
    "honest_witness": ("skipping", 1, PERIOD, "update", None),
    "lagging_witness": ("skipping", 1, PERIOD, "update", None),
    "down_witness": ("skipping", 1, PERIOD, "update", None),
    "forked_witness": ("skipping", 1, PERIOD, "update", None),
}


def run_case(monkeypatch, case: str, side: dict, port: bool):
    mode, trust_h, period, action, target = CASES[case]
    client_mod, store_mod = (pclient, plight_store) if port else (rclient, rlight_store)
    mods = pprovider if port else rprovider
    db_mod = pdb if port else rdb
    store_cls = PBlockStore if port else RBlockStore
    codec_mod = pcodec if port else rcodec
    primary, witnesses = providers(side, mods, case, db_mod, store_cls, codec_mod)
    trust = client_mod.TrustOptions(period_ns=period, height=trust_h,
                                    hash=side["blocks"].load_block_meta(trust_h).block_id.hash)
    light_store = store_mod.LightStore(db_mod.MemDB())
    extra = {"device": "cpu"} if port else {}
    with monkeypatch.context() as m:
        sent = Sent(m, B if port else RB)

        def go():
            c = client_mod.Client(CHAIN, trust, primary, witnesses, light_store,
                                  verification_mode=mode, **extra)
            got = c.update(now=NOW) if action == "update" else \
                c.verify_light_block_at_height(target, NOW)
            return got

        result = outcome(go)
    heights = [int.from_bytes(k[3:], "big") for k, _ in light_store.db.iterator()]
    evidence = [[codec_mod.encode_evidence(ev) for ev in p.reported]
                for p in [primary] + witnesses]
    return result, heights, sent.sent, evidence


@pytest.fixture(scope="module")
def stores():
    return fill(**SHAPE)


@pytest.mark.parametrize("case", list(CASES))
def test_client_equals_reference(monkeypatch, stores, case):
    r, p = stores
    ref = run_case(monkeypatch, case, r, port=False)
    got = run_case(monkeypatch, case, p, port=True)
    assert got == ref
    result, heights, sent, evidence = got
    want = {
        "skipping": (("ok",), [1, 8, 16]), "sequential": (("ok",), list(range(1, 11))),
        "backwards": (("ok",), [11, 16]), "honest_witness": (("ok",), [1, 8, 16]),
        "lagging_witness": (("ok",), [1, 8, 16]), "down_witness": (("ok",), [1, 8, 16]),
    }
    if case in want:
        assert (result, heights) == want[case]
    elif case == "expired":
        assert result[0] == "ErrOldHeaderExpired" and heights == [1]
    elif case == "missing":
        assert result == ("LightBlockNotFoundError", f"no block at height {TOP + 4}")
    elif case == "bad_sig":
        assert result == ("ErrInvalidHeader", "invalid commit: wrong signature (#0)")
    else:
        assert result[0] == "ErrLightClientAttack" and heights == [1, 8]
        assert [len(e) for e in evidence] == [1, 1]
    if case == "skipping":
        # the root's own commit (5 of 7 reach 2/3); 1 -> 16 refused by the
        # tally before any signature is sent (1 of 7 trusted); then 1 -> 8
        # and 8 -> 16, each a trusting check (3 reach 1/3) and its own
        assert sent == [5, 3, 5, 3, 5]


def test_attack_evidence_names_the_signers_bonded_at_the_common_height(monkeypatch, stores):
    """The forked witness's evidence: common height 8 (the last trusted
    block below the conflict), and as byzantine the conflicting commit's
    signers that were in height 8's set -- the reference's lunatic rule."""
    r, p = stores
    got = run_case(monkeypatch, "forked_witness", p, port=True)
    ev = pcodec.decode_evidence(got[3][0][0])
    gen, blocks, _ = chain(**SHAPE)
    common_vals = {v.address for v in blocks[6][3].validators.validators}   # height 8's
    signers = {cs.validator_address for cs in forked_top()[2].signatures}
    assert ev.common_height == 8 and set(ev.byzantine_validators) == signers & common_vals
    assert 0 < len(ev.byzantine_validators) < len(signers)


def test_witness_fault_reaches_the_caller(monkeypatch, stores):
    """The port's departure: a witness raising anything but ProviderError
    (here what a failed kernel launch looks like) is no witness that is
    down; the reference skips it and passes."""
    r, p = stores
    fault = RuntimeError("verify_keyed: CUDA launch failed with error 719")

    def with_faulty_witness(side, port):
        mods = pprovider if port else rprovider
        primary = Recording(mods.NodeProvider(CHAIN, side["blocks"], side["states"]))
        witness = Recording(primary.inner, fail=fault)
        client_mod = pclient if port else rclient
        trust = client_mod.TrustOptions(
            period_ns=PERIOD, height=1, hash=side["blocks"].load_block_meta(1).block_id.hash)
        store = (plight_store if port else rlight_store).LightStore(
            (pdb if port else rdb).MemDB())
        extra = {"device": "cpu"} if port else {}
        return lambda: client_mod.Client(CHAIN, trust, primary, [witness], store,
                                         **extra).update(now=NOW)

    assert outcome(with_faulty_witness(r, port=False)) == ("ok",)
    with pytest.raises(RuntimeError, match="error 719"):
        with_faulty_witness(p, port=True)()


def test_client_without_a_card_needs_device_cpu(monkeypatch, stores):
    """No ``device`` means cuda: without a card the client refuses to
    start instead of verifying on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, p = stores
    primary = pprovider.NodeProvider(CHAIN, p["blocks"], p["states"])
    trust = pclient.TrustOptions(period_ns=PERIOD, height=1,
                                 hash=p["blocks"].load_block_meta(1).block_id.hash)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        pclient.Client(CHAIN, trust, primary, [], plight_store.LightStore(pdb.MemDB()))
