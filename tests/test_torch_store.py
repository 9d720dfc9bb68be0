"""The port's persistence (cometbft_tpu_torch/utils/db.py, store/, state/,
light/store.py and metrics' StoreMetrics) against the reference's
(cometbft_tpu/...), which imports no jax for these modules.

The same operations go to both packages' backends: iteration order,
reverse ranges, ``prefix_end``, batches and a reopened sqlite file must
read alike.  A chain is built with the reference's types from seeded
keys (``State.make_block``, part sets, per-vote precommits, validator
rotations, a params change); each block, commit and state is carried
into the port by its wire bytes and saved there as the reference saves
it, each package over its own ``MemDB``.  Tolerance: the two DBs'
complete key -> value maps are equal byte for byte after every save,
prune and bootstrap; loads give the reference's bytes back; a refusal
is the same exception class and message.  The store metrics' exposition
is compared under one injected clock.

``chain()`` is shared with tests/test_torch_light_client.py."""

import json
from dataclasses import replace
from functools import lru_cache

import pytest

from cometbft_tpu import metrics as rmetrics
from cometbft_tpu import state as rstate
from cometbft_tpu import store as rstore
from cometbft_tpu.light import store as rlight_store
from cometbft_tpu.types import block as rblock
from cometbft_tpu.types import codec as rcodec
from cometbft_tpu.types import genesis as rgenesis
from cometbft_tpu.types import params as rparams
from cometbft_tpu.utils import db as rdb
from cometbft_tpu.utils import metrics as rumetrics
from cometbft_tpu_torch import metrics as pmetrics
from cometbft_tpu_torch import state as pstate
from cometbft_tpu_torch import store as pstore
from cometbft_tpu_torch.light import store as plight_store
from cometbft_tpu_torch.types import codec as pcodec
from cometbft_tpu_torch.types import genesis as pgenesis
from cometbft_tpu_torch.types import part_set as pparts
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.types.light_block import LightBlock as PLightBlock
from cometbft_tpu_torch.utils import db as pdb
from cometbft_tpu_torch.utils import metrics as pumetrics
from tests.test_torch_types import CHAIN, T0, outcome, port_commit, ref_keys, rng, \
    signed_precommit

BLOCK_NS = 5 * 10**9
PART = 700          # bytes a part: a block of this chain spans 2-3 parts


# -- the chain ---------------------------------------------------------------

def _rotate(next_vals, h: int, every: int, keep: int, originals: set, spare: list):
    """At every ``every``-th height's set one original validator leaves
    and a spare key joins, while more than ``keep`` originals are left."""
    if h % every != 1 or not spare:
        return next_vals, False
    left = sorted(v.address for v in next_vals.validators if v.address in originals)
    if len(left) <= keep:
        return next_vals, False
    out = next_vals.get_by_address(left[h % len(left)])[1]
    new = spare.pop(0)
    return next_vals.update_with_change_set([(out.pub_key, 0), (new.pub_key(), 10)]), True


@lru_cache(maxsize=4)
def chain(heights: int = 6, nval: int = 4, every: int = 3, keep: int = 1, tag: int = 0):
    """A reference chain of ``heights`` blocks: (genesis, [(block, part
    set, seen commit, state after the block)], keys by address).  State
    moves as the reference's update_state moves it: sets forward one
    height, a rotation lands in the height+2 set, one proposer step; the
    params change once (at the third block)."""
    g = rng(5000 + tag)
    keys = ref_keys(g, nval + heights)
    vals_keys, spare = keys[:nval], list(keys[nval:])
    by_addr = {k.pub_key().address(): k for k in keys}
    gen = rgenesis.GenesisDoc(
        chain_id=CHAIN, genesis_time_ns=T0, initial_height=1,
        validators=tuple(rgenesis.GenesisValidator(k.pub_key(), 10) for k in vals_keys),
        app_hash=g.bytes(32))
    state = rstate.State.from_genesis(gen)
    originals = {k.pub_key().address() for k in vals_keys}
    out, last_commit = [], None
    for h in range(1, heights + 1):
        t = T0 + h * BLOCK_NS
        txs = tuple(g.bytes(int(g.integers(20, 400))) for _ in range(int(g.integers(0, 6))))
        block = state.make_block(h, txs, last_commit, (),
                                 state.validators.get_proposer().address, t)
        parts = block.make_part_set(PART)
        bid = rblock.BlockID(hash=block.hash(), part_set_header=parts.header)
        sigs = []
        for i, v in enumerate(state.validators.validators):
            vote = signed_precommit(by_addr[v.address], i, bid, h, 0,
                                    t + BLOCK_NS // 2 + int(g.integers(0, 10**9)))
            sigs.append(vote.commit_sig())
        commit = rblock.Commit(height=h, round=0, block_id=bid, signatures=tuple(sigs))
        nxt, changed = _rotate(state.next_validators.copy(), h + 2, every, keep, originals,
                               spare)
        params = state.consensus_params
        if h == 3:
            params = replace(params, block=replace(params.block, max_bytes=1 << 20))
        state = replace(
            state, last_block_height=h, last_block_id=bid, last_block_time_ns=t,
            validators=state.next_validators.copy(),
            next_validators=nxt.increment_proposer_priority(1),
            last_validators=state.validators.copy(),
            last_height_validators_changed=(h + 2 if changed
                                            else state.last_height_validators_changed),
            consensus_params=params,
            last_height_params_changed=h + 1 if h == 3 else state.last_height_params_changed,
            last_results_hash=g.bytes(32), app_hash=g.bytes(32))
        out.append((block, parts, commit, state))
        last_commit = commit
    return gen, out, by_addr


def port_state(s) -> pstate.State:
    return pstate.decode_state(rstate.encode_state(s))


def port_parts(block) -> pparts.PartSet:
    """The port's part set of the reference block, from its wire bytes."""
    return pcodec.decode_block(block.encode()).make_part_set(PART)


def port_genesis(gen) -> pgenesis.GenesisDoc:
    return pgenesis.GenesisDoc.from_json(gen.to_json())


def image(db) -> dict:
    """A DB's complete key -> value map."""
    return dict(db.iterator())


def fill(n: int | None = None, ext_at: int | None = None, **kw):
    """Both packages' block and state stores, each over its own MemDB,
    with the chain's first ``n`` blocks and states (genesis first)."""
    gen, blocks, _ = chain(**kw)
    n = len(blocks) if n is None else n
    r = dict(bdb=rdb.MemDB(), sdb=rdb.MemDB())
    p = dict(bdb=pdb.MemDB(), sdb=pdb.MemDB())
    r["blocks"], p["blocks"] = rstore.BlockStore(r["bdb"]), pstore.BlockStore(p["bdb"])
    r["states"], p["states"] = rstate.Store(r["sdb"]), pstate.Store(p["sdb"])
    r["states"].save(rstate.State.from_genesis(gen))
    p["states"].save(pstate.State.from_genesis(port_genesis(gen)))
    for block, parts, commit, st in blocks[:n]:
        h = block.header.height
        ext = None
        if h == ext_at:
            ext = [signed_precommit(k, i, commit.block_id, h, 0, T0) if i % 2 == 0 else None
                   for i, k in enumerate(sorted(chain(**kw)[2].values(),
                                                key=lambda k: k.pub_key().address())[:3])]
        r["blocks"].save_block(block, parts, commit, extended_votes=ext)
        p["blocks"].save_block(
            pcodec.decode_block(block.encode()), port_parts(block), port_commit(commit),
            extended_votes=None if ext is None else
            [None if v is None else pvote.Vote.decode(v.encode()) for v in ext])
        r["states"].save(st)
        p["states"].save(port_state(st))
    return r, p


def assert_images_equal(r, p) -> None:
    assert image(p["bdb"]) == image(r["bdb"])
    assert image(p["sdb"]) == image(r["sdb"])


# -- the key-value seam --------------------------------------------------------

def _ops(g, n: int):
    keys = [bytes(g.integers(0, 256, int(g.integers(0, 4))).astype("uint8"))
            for _ in range(24)] + [b"a", b"a\xff", b"\xff", b"\xff\xff", b"b"]
    out = []
    for _ in range(n):
        k = keys[int(g.integers(0, len(keys)))]
        kind = int(g.integers(0, 4))
        if kind == 3:
            out.append(("batch", [(keys[int(g.integers(0, len(keys)))],
                                   None if g.integers(0, 3) == 0 else g.bytes(3))
                                  for _ in range(int(g.integers(1, 5)))]))
        elif kind == 2:
            out.append(("delete", k))
        else:
            out.append(("set", k, g.bytes(int(g.integers(0, 6)))))
    return out


def _apply(db, ops) -> None:
    for op in ops:
        if op[0] == "set":
            db.set(op[1], op[2])
        elif op[0] == "delete":
            db.delete(op[1])
        else:
            db.write_batch(op[1])


def _reads(db, g) -> list:
    bounds = [None, b"", b"\x00", b"a", b"a\xff", b"b", b"\x80", b"\xff", b"\xff\xff"]
    out = [list(db.iterator()), list(db.reverse_iterator())]
    for _ in range(12):
        lo = bounds[int(g.integers(0, len(bounds)))]
        hi = bounds[int(g.integers(0, len(bounds)))]
        out.append(list(db.iterator(lo, hi)))
        out.append(list(db.reverse_iterator(lo, hi)))
    for p in (b"", b"a", b"\xff", b"\x00"):
        out.append(list(db.prefix_iterator(p)))
    out.append([db.has(k) for k, _ in out[0]] + [db.get(b"never-set")])
    return out


@pytest.mark.parametrize("backend", ["memdb", "sqlite"])
@pytest.mark.parametrize("trial", range(3))
def test_db_semantics_equal_reference(tmp_path, backend, trial):
    """Sets, deletes and batches, then full, ranged, reverse and prefix
    reads; for sqlite the same reads after closing and opening again."""
    g = rng(5100 + trial)
    ops = _ops(g, 80)
    r = rdb.open_db("kv", backend, str(tmp_path / "ref"))
    p = pdb.open_db("kv", backend, str(tmp_path / "port"))
    _apply(r, ops)
    _apply(p, ops)
    assert _reads(p, rng(5150 + trial)) == _reads(r, rng(5150 + trial))
    if backend == "sqlite":
        r.close()
        p.close()
        r = rdb.open_db("kv", backend, str(tmp_path / "ref"))
        p = pdb.open_db("kv", backend, str(tmp_path / "port"))
        assert _reads(p, rng(5160 + trial)) == _reads(r, rng(5160 + trial))
        p.compact()
        assert _reads(p, rng(5170)) == _reads(r, rng(5170))
    r.close()
    p.close()


@pytest.mark.parametrize("prefix", [b"", b"a", b"ab", b"a\xff", b"\xff", b"\xff\xff",
                                    b"\x00", b"x\xff\xff"])
def test_prefix_end_equals_reference(prefix):
    assert pdb.prefix_end(prefix) == rdb.prefix_end(prefix)


def test_db_refusals_equal_reference(tmp_path):
    """A non-bytes value and an unknown backend; ``cometkv`` is the
    port's departure: not ported yet, refused with DBError."""
    assert outcome(lambda: pdb.MemDB().set(b"k", "text")) == \
        outcome(lambda: rdb.MemDB().set(b"k", "text")) == ("DBError", "value must be bytes")
    assert outcome(lambda: pdb.open_db("x", "leveldb", str(tmp_path))) == \
        outcome(lambda: rdb.open_db("x", "leveldb", str(tmp_path)))
    with pytest.raises(pdb.DBError, match="'cometkv' is not ported yet"):
        pdb.open_db("x", "cometkv", str(tmp_path))


# -- the block store -----------------------------------------------------------

def test_block_and_state_store_images_equal_reference():
    """Every block, its parts, metas, commits, seen commits, extended
    votes and every state: the two DBs' images equal after each height."""
    gen, blocks, _ = chain()
    for n in range(1, len(blocks) + 1):
        r, p = fill(n, ext_at=2)
        assert_images_equal(r, p)
    assert (p["blocks"].base(), p["blocks"].height(), p["blocks"].size()) == \
        (r["blocks"].base(), r["blocks"].height(), r["blocks"].size()) == (1, 6, 6)


def test_block_store_loads_equal_reference():
    r, p = fill(ext_at=2)
    rb, pb = r["blocks"], p["blocks"]
    for h in range(0, 8):
        rblk, pblk = rb.load_block(h), pb.load_block(h)
        assert (pblk is None) == (rblk is None)
        if rblk is None:
            continue
        assert pblk.encode() == rblk.encode()
        assert pb.load_block_meta(h).encode() == rb.load_block_meta(h).encode()
        assert pb.load_block_by_hash(rblk.hash()).encode() == rblk.encode()
        total = rb.load_block_meta(h).block_id.part_set_header.total
        assert total > 1
        for i in range(total + 1):
            rp, pp = rb.load_block_part(h, i), pb.load_block_part(h, i)
            assert (None if pp is None else pcodec.encode_part(pp)) == \
                (None if rp is None else rcodec.encode_part(rp))
        for fn in ("load_block_commit", "load_seen_commit"):
            rc, pc = getattr(rb, fn)(h), getattr(pb, fn)(h)
            assert (None if pc is None else pcodec.encode_commit(pc)) == \
                (None if rc is None else rcodec.encode_commit(rc))
        assert pb.load_seen_extended_votes_raw(h) == rb.load_seen_extended_votes_raw(h)
    votes = pb.load_seen_extended_votes(2)
    assert [None if v is None else v.encode() for v in votes] == \
        [None if v is None else v.encode() for v in rb.load_seen_extended_votes(2)]
    assert pb.load_block_by_hash(b"\x00" * 32) is None
    # a reopened store (a new BlockStore over the same DB) reads its range
    again = pstore.BlockStore(p["bdb"])
    assert (again.base(), again.height()) == (1, 6)
    assert again.load_block(4).encode() == rb.load_block(4).encode()


@pytest.mark.parametrize("retain", [1, 3, 6])
def test_block_store_pruning_equals_reference(retain):
    r, p = fill(ext_at=2)
    assert p["blocks"].prune_blocks(retain) == r["blocks"].prune_blocks(retain)
    assert p["blocks"].base() == r["blocks"].base()
    assert_images_equal(r, p)
    p["blocks"].prune_last_block()
    r["blocks"].prune_last_block()
    assert (p["blocks"].base(), p["blocks"].height()) == \
        (r["blocks"].base(), r["blocks"].height())
    assert_images_equal(r, p)
    assert outcome(lambda: p["blocks"].prune_blocks(9)) == \
        outcome(lambda: r["blocks"].prune_blocks(9))


def test_block_store_refusals_equal_reference():
    """A non-monotonic save, an incomplete part set and an empty store's
    prune_last_block: the same class and message."""
    gen, blocks, _ = chain()
    r, p = fill(3)
    block, parts, commit, _ = blocks[4]      # height 5 after height 3
    got_r = outcome(lambda: r["blocks"].save_block(block, parts, commit))
    got_p = outcome(lambda: p["blocks"].save_block(
        pcodec.decode_block(block.encode()), port_parts(block), port_commit(commit)))
    assert got_p == got_r == ("BlockStoreError", "cannot save block 5, expected 4")
    block, parts, commit, _ = blocks[3]
    rpart = type(parts)(parts.header)
    ppart = pparts.PartSet(port_parts(block).header)
    assert outcome(lambda: p["blocks"].save_block(pcodec.decode_block(block.encode()), ppart,
                                                  port_commit(commit))) == \
        outcome(lambda: r["blocks"].save_block(block, rpart, commit))
    assert outcome(pstore.BlockStore(pdb.MemDB()).prune_last_block) == \
        outcome(rstore.BlockStore(rdb.MemDB()).prune_last_block)
    assert_images_equal(r, p)


# -- the state store -----------------------------------------------------------

def test_state_store_loads_prune_and_bootstrap_equal_reference():
    gen, blocks, _ = chain()
    r, p = fill()
    assert pstate.encode_state(p["states"].load()) == rstate.encode_state(r["states"].load())
    for h in range(1, 9):
        rv, pv = outcome(lambda: r["states"].load_validators(h)), \
            outcome(lambda: p["states"].load_validators(h))
        assert pv == rv
        if rv == ("ok",):
            assert pstate.encode_validator_set(p["states"].load_validators(h)) == \
                rstate.encode_validator_set(r["states"].load_validators(h))
        assert pstate.encode_consensus_params(p["states"].load_consensus_params(h)) == \
            rstate.encode_consensus_params(r["states"].load_consensus_params(h))
    for store in (r["states"], p["states"]):
        store.prune(4)
    assert_images_equal(r, p)
    assert outcome(lambda: p["states"].load_validators(2)) == \
        outcome(lambda: r["states"].load_validators(2))
    assert outcome(lambda: p["states"].load_consensus_params(2)) == \
        outcome(lambda: r["states"].load_consensus_params(2))
    # statesync's bootstrap into fresh stores
    rb, pb = rstate.Store(rdb.MemDB()), pstate.Store(pdb.MemDB())
    st = blocks[3][3]
    rb.bootstrap(st)
    pb.bootstrap(port_state(st))
    assert image(pb._db) == image(rb._db)


def test_state_codecs_and_make_block_equal_reference():
    gen, blocks, _ = chain()
    pgen = port_genesis(gen)
    assert pstate.encode_state(pstate.State.from_genesis(pgen)) == \
        rstate.encode_state(rstate.State.from_genesis(gen))
    for block, _, commit, st in blocks:
        pst = port_state(st)
        assert pstate.encode_state(pst) == rstate.encode_state(st)
        assert pstate.encode_consensus_params(pst.consensus_params) == \
            rstate.encode_consensus_params(st.consensus_params)
    prev = blocks[2][3]
    rblk = prev.make_block(4, (b"tx",), blocks[2][2], (), prev.validators.get_proposer().address,
                           T0 + 99)
    pblk = port_state(prev).make_block(4, (b"tx",), port_commit(blocks[2][2]), (),
                                       prev.validators.get_proposer().address, T0 + 99)
    assert pblk.encode() == rblk.encode() and pblk.hash() == rblk.hash()


@pytest.mark.parametrize("case", ["fresh", "stored", "other_chain", "bad_marker",
                                  "legacy_responses", "key_type"])
def test_state_loading_and_refusals_equal_reference(case):
    """load_state_from_db_or_genesis on an empty and on a filled store, a
    genesis of another chain, and Store.__init__'s format checks."""
    gen, blocks, _ = chain()

    def run(st_mod, db_mod, gen_doc, state_of):
        db = db_mod.MemDB()
        if case == "bad_marker":
            db.set(b"abciResponsesFormat", b"v1")
        if case == "legacy_responses":
            db.set(b"abciResponsesKey:" + (1).to_bytes(8, "big"), b"\x01")
        if case == "key_type":
            raw = st_mod.encode_validator_set(state_of(blocks[0][3]).validators)
            bad = raw.replace(b"ed25519", b"sr25519")
            return lambda: st_mod.decode_validator_set(bad)
        store = None

        def go():
            nonlocal store
            store = st_mod.Store(db)
            if case in ("stored", "other_chain"):
                store.save(state_of(blocks[2][3]))
            doc = gen_doc if case != "other_chain" else replace(gen_doc, chain_id="other")
            return st_mod.encode_state(st_mod.load_state_from_db_or_genesis(store, doc))

        return go

    ref = outcome(run(rstate, rdb, gen, lambda s: s))
    got = outcome(run(pstate, pdb, port_genesis(gen), port_state))
    assert got == ref
    if ref == ("ok",):
        assert run(pstate, pdb, port_genesis(gen), port_state)() == \
            run(rstate, rdb, gen, lambda s: s)()


# -- the light store ---------------------------------------------------------------

def test_light_store_order_equals_reference():
    """LightStore keyed by height: first, latest, light_block_before,
    size and prune read heights in order in both packages."""
    from cometbft_tpu.types.light_block import LightBlock as RLightBlock
    from cometbft_tpu.types.light_block import SignedHeader as RSignedHeader

    gen, blocks, _ = chain()
    rls, pls = rlight_store.LightStore(rdb.MemDB()), plight_store.LightStore(pdb.MemDB())
    vals = {1: rstate.State.from_genesis(gen).validators}
    for block, _, _, st in blocks:
        vals[block.header.height + 1] = st.validators
    for h in (5, 1, 3, 6, 2):
        block, _, commit, _ = blocks[h - 1]
        lb = RLightBlock(RSignedHeader(block.header, commit), vals[h])
        rls.save(lb)
        pls.save(PLightBlock.decode(lb.encode()))
    assert image(pls.db) == image(rls.db)

    def heights(ls):
        out = [ls.first().height, ls.latest().height, ls.size()]
        for h in range(0, 8):
            b = ls.light_block_before(h)
            out.append(None if b is None else (b.height, b.hash()))
        return out

    assert heights(pls) == heights(rls)
    assert pls.get(3).encode() == rls.get(3).encode() and pls.get(4) is None
    pls.delete(3)
    rls.delete(3)
    assert pls.prune(2) == rls.prune(2) == 2
    assert heights(pls) == heights(rls) and image(pls.db) == image(rls.db)


# -- the store metrics ---------------------------------------------------------

class _Clock:
    """time.perf_counter for a store module: 1 ms a reading."""

    def __init__(self) -> None:
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 0.001
        return self.t


def test_store_metrics_exposition_equals_reference(monkeypatch):
    """save, load and prune through a BlockStore built on each package's
    StoreMetrics: the same exposition under one injected clock."""
    gen, blocks, _ = chain()
    monkeypatch.setattr(rstore, "time", _Clock())
    monkeypatch.setattr(pstore, "time", _Clock())
    rreg, preg = rumetrics.Registry(), pumetrics.Registry()
    rbs = rstore.BlockStore(rdb.MemDB(), metrics=rmetrics.StoreMetrics(rreg))
    pbs = pstore.BlockStore(pdb.MemDB(), metrics=pmetrics.StoreMetrics(preg))
    for block, parts, commit, _ in blocks[:4]:
        rbs.save_block(block, parts, commit)
        pbs.save_block(pcodec.decode_block(block.encode()), port_parts(block),
                       port_commit(commit))
    for h in (1, 2, 4):
        rbs.load_block(h)
        pbs.load_block(h)
    assert pbs.prune_blocks(3) == rbs.prune_blocks(3) == 2
    text = preg.expose()
    assert text == rreg.expose()
    assert "cometbft_store_block_save_seconds_count 4" in text
    assert "cometbft_store_block_load_seconds_count 3" in text
    assert "cometbft_store_block_prune_seconds_count 1" in text
    assert [ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")] == \
        ["cometbft_store_block_save_seconds", "cometbft_store_block_load_seconds",
         "cometbft_store_block_prune_seconds"]


def test_params_change_is_stored_from_its_height():
    """The chain's params change at block 3 reads back from height 4 on,
    in both packages (the reverse range read)."""
    r, p = fill()
    want = rparams.ConsensusParams().block.max_bytes
    for h, max_bytes in ((3, want), (4, 1 << 20), (6, 1 << 20)):
        got_r = r["states"].load_consensus_params(h).block.max_bytes
        got_p = p["states"].load_consensus_params(h).block.max_bytes
        assert got_p == got_r == max_bytes
    assert json.loads(pstate.encode_consensus_params(p["states"].load_consensus_params(5))) == \
        json.loads(rstate.encode_consensus_params(r["states"].load_consensus_params(5)))
