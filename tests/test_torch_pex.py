"""p2p/pex: the port's address book and PEX reactor against the
reference's — the codec's bytes, the book's buckets, picks and
selections under one ``rng`` and ``key``, its file in both directions,
and discovery through a seed over TCP between port and reference nodes.
Ensure intervals are sub-second and every wait is bounded."""

import json
import os
import random
import time

import pytest

from cometbft_tpu.p2p import netaddr as ref_na
from cometbft_tpu.p2p.pex import addrbook as ref_ab
from cometbft_tpu.p2p.pex import reactor as ref_rx
from cometbft_tpu_torch.p2p import netaddr as port_na
from cometbft_tpu_torch.p2p.pex import addrbook as port_ab
from cometbft_tpu_torch.p2p.pex import reactor as port_rx

KEY = "5eed" * 12
PKGS = {"ref": (ref_na, ref_ab, ref_rx), "port": (port_na, port_ab, port_rx)}


def _nid(i: int) -> str:
    return ("%040x" % (0x1000 + i * 7919))[-40:]


def _addrs(na, n: int, public: bool = True):
    out = []
    for i in range(n):
        host = f"{20 + i % 7}.{i % 5}.{i % 3}.{1 + i}" if public else "127.0.0.1"
        out.append(na.NetAddress(id=_nid(i), host=host, port=26656 + i))
    return out


# -- the codec -------------------------------------------------------------


def test_pex_codec_bytes_both_ways():
    assert port_rx.encode_pex_request() == ref_rx.encode_pex_request()
    ref_bytes = ref_rx.encode_pex_addrs(_addrs(ref_na, 300))
    port_bytes = port_rx.encode_pex_addrs(_addrs(port_na, 300))
    assert port_bytes == ref_bytes                       # capped at 250 alike
    for raw in (ref_bytes, port_bytes, ref_rx.encode_pex_request()):
        (rk, ra), (pk, pa) = ref_rx.decode_pex_msg(raw), port_rx.decode_pex_msg(raw)
        assert rk == pk
        assert [(a.id, a.host, a.port) for a in (ra or [])] == \
            [(a.id, a.host, a.port) for a in (pa or [])]
    assert len(port_rx.decode_pex_msg(ref_bytes)[1]) == 250
    for bad in (b"\x00garbage", b"\x1a\x00", b""):
        errs = []
        for mod in (ref_rx, port_rx):
            with pytest.raises(ValueError) as exc:
                mod.decode_pex_msg(bad)
            errs.append(str(exc.value))
        assert errs[0] == errs[1]


# -- the book ----------------------------------------------------------------


def _book(which: str, path: str, strict: bool, seed: int):
    _, ab, _ = PKGS[which]
    if which == "port":
        return ab.AddrBook(path, strict=strict, rng=random.Random(seed), key=KEY)
    book = ab.AddrBook(path, strict=strict)
    book._rng, book._key = random.Random(seed), KEY
    return book


def _state(book) -> dict:
    return {
        "new": [sorted(b) for b in book._new],
        "old": [sorted(b) for b in book._old],
        "addrs": {i: (str(ka.addr), ka.src_id, ka.attempts, ka.bucket_type, list(ka.buckets))
                  for i, ka in book._addrs.items()},
    }


def _drive(which: str, path: str, strict: bool) -> dict:
    """One scripted history of a book; -> its states, picks, selections."""
    na, _, _ = PKGS[which]
    book = _book(which, path, strict, seed=99)
    addrs = _addrs(na, 90, public=strict)
    srcs = [na.NetAddress(id=_nid(500 + k), host=f"{60 + k}.1.1.1", port=1) for k in range(4)]
    crowd = [na.NetAddress(id=_nid(1000 + i), host=f"77.7.{i}.1", port=2) for i in range(80)]
    trace = {"added": []}
    for i, a in enumerate(addrs):
        trace["added"].append(book.add_address(a, srcs[i % len(srcs)]))
    for a in crowd:                                  # one group, one source: evictions
        trace["added"].append(book.add_address(a, srcs[0]))
    trace["after_add"] = _state(book)
    for a in addrs[:25]:
        book.mark_attempt(a)
    for a in addrs[5:30]:
        book.mark_good(a.id)
    for a in addrs[30:33]:
        book.mark_bad(a)
    book.add_our_address(addrs[40])
    trace["re_add"] = [book.add_address(a, srcs[1]) for a in addrs[35:45]]
    trace["after_marks"] = _state(book)
    trace["picks"] = [(None if p is None else p.id)
                      for bias in (0, 30, 50, 100) for p in
                      (book.pick_address(bias) for _ in range(25))]
    trace["selections"] = [[a.id for a in book.get_selection()] for _ in range(3)]
    trace["size"] = book.size()
    book.save()
    return trace


@pytest.mark.parametrize("strict", [True, False])
def test_the_book_matches_the_reference_under_one_rng_and_key(tmp_path, strict):
    ref = _drive("ref", str(tmp_path / "ref.json"), strict)
    port = _drive("port", str(tmp_path / "port.json"), strict)
    assert port == ref
    if strict:
        assert sum(ref["added"]) > 0 and any(ref["after_marks"]["old"])
    else:
        assert ref["size"] > 0                          # 127.0.0.1 allowed when loose
    files = []
    for name in ("ref.json", "port.json"):
        data = json.load(open(tmp_path / name))
        for d in data["addrs"]:          # wall-clock stamps of the two runs
            d.pop("last_attempt"), d.pop("last_success")
        files.append(data)
    assert files[0] == files[1]


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_the_book_file_crosses(tmp_path, writer, reader):
    path = str(tmp_path / "book.json")
    _drive(writer, path, strict=True)
    wrote = json.load(open(path))
    _, ab, _ = PKGS[reader]
    book = ab.AddrBook(path, strict=True)
    book._load()
    assert book._key == KEY
    assert {i: ka.to_json() for i, ka in book._addrs.items()} == \
        {d["addr"].split("@")[0]: d for d in wrote["addrs"]}
    assert book.size() == len(wrote["addrs"]) > 0
    assert sum(1 for d in wrote["addrs"] if d["bucket_type"] == "old") == \
        sum(1 for ka in book._addrs.values() if ka.is_old) > 0
    for ka in book._addrs.values():
        store = book._old if ka.is_old else book._new
        assert all(ka.addr.id in store[b] for b in ka.buckets)


# -- discovery over TCP ------------------------------------------------------


def _node(which: str, tmp_path, name: str, seeds=(), seed_mode=False):
    import importlib

    pkg = "cometbft_tpu_torch" if which == "port" else "cometbft_tpu"
    tu = importlib.import_module(f"{pkg}.p2p.test_util")
    pex = importlib.import_module(f"{pkg}.p2p.pex")
    book = pex.AddrBook(str(tmp_path / f"{name}.json"), strict=False)
    r = pex.PexReactor(book, seeds=list(seeds), seed_mode=seed_mode, ensure_interval=0.2)
    sw = tu.make_switch(moniker=name, reactors={"PEX": r})
    if which == "ref":
        sw.addr_book = book          # the reference's node assembly sets it
    return sw, book


def _addr_of(sw, na):
    a = sw.transport.listen_addr
    return na.NetAddress(id=a.id, host=a.host, port=a.port)


@pytest.mark.parametrize("seed_side,fresh_side", [("port", "port"), ("ref", "port"),
                                                  ("port", "ref")])
def test_a_fresh_node_learns_a_peer_from_a_seed(tmp_path, seed_side, fresh_side):
    """The fresh node is given only the seed's address.  A port seed
    runs in seed mode (it serves its book, then hangs up); the
    reference's seed mode stops the peer before its reply is written,
    so the reference seed is an ordinary node, as in the reference's own
    discovery test."""
    switches = []
    try:
        target, _ = _node("port", tmp_path, "target")
        seed_na = PKGS[seed_side][0]
        seed, seed_book = _node(seed_side, tmp_path, "seed", seed_mode=(seed_side == "port"))
        switches += [target, seed]
        target.start()
        seed_book.add_address(_addr_of(target, seed_na), _addr_of(target, seed_na))
        seed.start()
        fresh_na = PKGS[fresh_side][0]
        fresh, fresh_book = _node(fresh_side, tmp_path, "fresh",
                                  seeds=[_addr_of(seed, fresh_na)])
        switches.append(fresh)
        fresh.start()
        tid = target.node_info().node_id
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not (
                fresh.peers.has(tid) and fresh_book.is_good(_addr_of(target, fresh_na))):
            time.sleep(0.02)
        assert fresh_book.has_address(_addr_of(target, fresh_na))
        assert fresh.peers.has(tid), f"book {fresh_book.size()}, peers {fresh.peers.size()}"
        assert fresh_book.is_good(_addr_of(target, fresh_na))     # the dial marked it good
    finally:
        for sw in reversed(switches):
            if sw.is_running():
                sw.stop()


def test_setting_the_reactor_gives_the_switch_its_book(tmp_path):
    sw, book = _node("port", tmp_path, "n")
    try:
        assert sw.addr_book is book
    finally:
        sw.transport.on_stop()


def test_a_seed_hangs_up_only_after_its_reply(tmp_path, monkeypatch):
    """The port seed's reply reaches the dialer before the hang-up, each
    of several times in a row (the reference's loses it)."""
    switches = []
    try:
        seed, seed_book = _node("port", tmp_path, "seed", seed_mode=True)
        switches.append(seed)
        far = port_na.NetAddress(id=_nid(7), host="10.9.8.7", port=26656)
        seed_book.add_address(far, far)
        seed.start()
        for k in range(3):
            fresh, book = _node("port", tmp_path, f"fresh{k}", seeds=[_addr_of(seed, port_na)])
            switches.append(fresh)
            fresh.start()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and not book.has_address(far):
                time.sleep(0.01)
            assert book.has_address(far)
            def inbound():
                return [p for p in seed.peers.copy() if not p.outbound]

            while time.monotonic() < deadline and inbound():
                time.sleep(0.01)
            assert not inbound()                   # the seed hung up (its crawl dials stay)
            fresh.stop()
    finally:
        for sw in switches:
            if sw.is_running():
                sw.stop()
    assert os.path.exists(tmp_path / "seed.json")
