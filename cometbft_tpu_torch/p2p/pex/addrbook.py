"""Bucketed peer address book (a copy of cometbft_tpu/p2p/pex/addrbook.py;
reference: p2p/pex/addrbook.go:88).

Addresses live in hashed buckets, split into "new" (heard about, never
connected) and "old" (proven good).  Bucket placement keys on the
address group (/16 for routable IPv4) and the source's group, so one
peer — or one subnet — can only pollute a bounded slice of the book
(eclipse resistance, the bitcoin addrman design the reference follows).

Persisted as JSON and reloaded on start (p2p/pex/file.go); a book file
written by either package loads in the other.

Where the port departs from its reference: the reference draws its
picks from an unseeded ``random.Random()`` and its bucket key from
``os.urandom(24)``; the port takes both as constructor arguments
(``rng``, ``key``; the same defaults when omitted), so a test or a
caller can reproduce a book's buckets, picks and selections.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time

from cometbft_tpu_torch.p2p.netaddr import NetAddress
from cometbft_tpu_torch.utils.log import Logger, default_logger
from cometbft_tpu_torch.utils.service import BaseService
from cometbft_tpu_torch.utils import sync as cmtsync

# Layout constants (addrbook.go:160-190 bucket parameters).
NEW_BUCKET_COUNT = 256
OLD_BUCKET_COUNT = 64
NEW_BUCKETS_PER_ADDRESS = 4
BUCKET_SIZE = 64
OLD_BUCKET_SIZE = 64

# Selection behavior (addrbook.go getSelection).
GET_SELECTION_PERCENT = 23
MAX_GET_SELECTION = 250
MIN_GET_SELECTION = 32

BUCKET_TYPE_NEW = "new"
BUCKET_TYPE_OLD = "old"

_SAVE_INTERVAL = 120.0  # dumpAddressInterval (addrbook.go:93)


class AddrBookError(Exception):
    pass


class KnownAddress:
    """(p2p/pex/known_address.go KnownAddress)"""

    def __init__(self, addr: NetAddress, src_id: str):
        self.addr = addr
        self.src_id = src_id
        self.attempts = 0
        self.last_attempt = 0.0
        self.last_success = 0.0
        self.bucket_type = BUCKET_TYPE_NEW
        self.buckets: list[int] = []

    @property
    def is_old(self) -> bool:
        return self.bucket_type == BUCKET_TYPE_OLD

    def is_bad(self, now: float | None = None) -> bool:
        """(known_address.go isBad) — too many failed attempts and no
        recent success."""
        now = now or time.time()
        if self.last_attempt and now - self.last_attempt < 60:
            return False
        if self.attempts >= 3 and not self.last_success:
            return True
        return self.attempts >= 10

    def to_json(self) -> dict:
        return {
            "addr": str(self.addr),
            "src": self.src_id,
            "attempts": self.attempts,
            "last_attempt": self.last_attempt,
            "last_success": self.last_success,
            "bucket_type": self.bucket_type,
            "buckets": self.buckets,
        }

    @classmethod
    def from_json(cls, d: dict) -> "KnownAddress":
        ka = cls(NetAddress.parse(d["addr"]), d.get("src", ""))
        ka.attempts = int(d.get("attempts", 0))
        ka.last_attempt = float(d.get("last_attempt", 0))
        ka.last_success = float(d.get("last_success", 0))
        ka.bucket_type = d.get("bucket_type", BUCKET_TYPE_NEW)
        ka.buckets = [int(b) for b in d.get("buckets", [])]
        return ka


def _strict_routable(addr: NetAddress) -> bool:
    """Strict-mode routability (netaddress.go:315 Routable): loopback,
    link-local, and RFC-1918 private ranges are not dialable from the
    public internet and stay out of a strict book."""
    if not addr.routable():
        return False
    host = addr.host.lower()
    if host in ("localhost", "::1"):
        return False
    parts = host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        a, b = int(parts[0]), int(parts[1])
        if a == 127 or a == 10 or a == 0:
            return False
        if a == 172 and 16 <= b <= 31:
            return False
        if a == 192 and b == 168:
            return False
        if a == 169 and b == 254:
            return False
    return True


def _group(addr: NetAddress) -> str:
    """Address group for bucket hashing (addrbook.go groupKey): /16 for
    IPv4-looking hosts, whole host otherwise; unroutable -> 'local'."""
    if not addr.routable():
        return "local"
    parts = addr.host.split(".")
    if len(parts) == 4 and all(p.isdigit() for p in parts):
        return f"{parts[0]}.{parts[1]}"
    return addr.host


class AddrBook(BaseService):
    """(p2p/pex/addrbook.go:88 addrBook)"""

    def __init__(
        self,
        file_path: str,
        strict: bool = True,
        logger: Logger | None = None,
        rng: random.Random | None = None,
        key: str | None = None,
    ):
        super().__init__(name="addrbook")
        self.file_path = file_path
        self.strict = strict
        self.logger = logger or default_logger().with_fields(
            module="addrbook"
        )
        self._mtx = cmtsync.Mutex()
        self._addrs: dict[str, KnownAddress] = {}  # node id -> ka
        self._new: list[set[str]] = [
            set() for _ in range(NEW_BUCKET_COUNT)
        ]
        self._old: list[set[str]] = [set() for _ in range(OLD_BUCKET_COUNT)]
        self._rng = rng if rng is not None else random.Random()
        # per-book hash key so bucket placement differs across nodes
        # (addrbook.go:116 key) — persisted with the book.
        self._key = key if key is not None else os.urandom(24).hex()
        self._our_ids: set[str] = set()
        self._private_ids: set[str] = set()
        self._dirty = False
        self._save_mtx = cmtsync.Mutex()  # serializes file writes

    # -- lifecycle -------------------------------------------------------

    def on_start(self) -> None:
        self._load()
        threading.Thread(
            target=self._save_routine, name="addrbook-save", daemon=True
        ).start()

    def on_stop(self) -> None:
        self.save()

    # -- identity / filtering -------------------------------------------

    def add_our_address(self, addr: NetAddress) -> None:
        with self._mtx:
            self._our_ids.add(addr.id)

    def is_our_address(self, addr: NetAddress) -> bool:
        with self._mtx:
            return addr.id in self._our_ids

    def add_private_ids(self, ids: list[str]) -> None:
        with self._mtx:
            self._private_ids.update(ids)

    # -- core ops --------------------------------------------------------

    def add_address(self, addr: NetAddress, src: NetAddress) -> bool:
        """(addrbook.go:262 AddAddress) — record a heard-about address
        into a new bucket keyed on (addr group, src group)."""
        with self._mtx:
            return self._add_locked(addr, src.id if src else "")

    def _add_locked(self, addr: NetAddress, src_id: str) -> bool:
        if not addr.id or addr.id in self._our_ids:
            return False
        if addr.id in self._private_ids:
            return False
        if self.strict and not _strict_routable(addr):
            return False
        ka = self._addrs.get(addr.id)
        if ka is not None:
            if ka.is_old:
                return False
            # refresh the address; allow an extra new-bucket placement
            ka.addr = addr
            if len(ka.buckets) >= NEW_BUCKETS_PER_ADDRESS:
                return False
        else:
            ka = KnownAddress(addr, src_id)
            self._addrs[addr.id] = ka
        bucket = self._bucket_index(
            BUCKET_TYPE_NEW, _group(addr), _group_of_src(self, src_id)
        )
        self._place_new_locked(ka, bucket)
        self._dirty = True
        return True

    def _place_new_locked(self, ka: KnownAddress, bucket: int) -> None:
        if bucket in ka.buckets:
            return
        if len(self._new[bucket]) >= BUCKET_SIZE:
            self._expire_new_bucket_locked(bucket)
        self._new[bucket].add(ka.addr.id)
        ka.buckets.append(bucket)

    def _expire_new_bucket_locked(self, bucket: int) -> None:
        """Evict the worst address from an over-full new bucket
        (addrbook.go expireNew: bad first, else oldest attempt)."""
        members = [
            self._addrs[i] for i in self._new[bucket] if i in self._addrs
        ]
        if not members:
            self._new[bucket].clear()
            return
        bad = [ka for ka in members if ka.is_bad()]
        victim = (
            bad[0]
            if bad
            else min(members, key=lambda ka: ka.last_attempt)
        )
        self._remove_from_bucket_locked(victim, bucket)
        if not victim.buckets:
            self._addrs.pop(victim.addr.id, None)

    def _remove_from_bucket_locked(self, ka: KnownAddress, bucket: int):
        store = self._old if ka.is_old else self._new
        store[bucket].discard(ka.addr.id)
        if bucket in ka.buckets:
            ka.buckets.remove(bucket)

    def remove_address(self, addr: NetAddress) -> None:
        with self._mtx:
            ka = self._addrs.pop(addr.id, None)
            if ka is None:
                return
            for b in list(ka.buckets):
                self._remove_from_bucket_locked(ka, b)
            self._dirty = True

    def mark_attempt(self, addr: NetAddress) -> None:
        with self._mtx:
            ka = self._addrs.get(addr.id)
            if ka is not None:
                ka.attempts += 1
                ka.last_attempt = time.time()
                self._dirty = True

    def mark_good(self, node_id: str) -> None:
        """(addrbook.go:340 MarkGood) — promote to an old bucket."""
        with self._mtx:
            ka = self._addrs.get(node_id)
            if ka is None:
                return
            ka.attempts = 0
            ka.last_success = time.time()
            ka.last_attempt = ka.last_success
            if not ka.is_old:
                self._promote_locked(ka)
            self._dirty = True

    def _promote_locked(self, ka: KnownAddress) -> None:
        for b in list(ka.buckets):
            self._new[b].discard(ka.addr.id)
        ka.buckets.clear()
        ka.bucket_type = BUCKET_TYPE_OLD
        bucket = self._bucket_index(
            BUCKET_TYPE_OLD, _group(ka.addr), ""
        )
        if len(self._old[bucket]) >= OLD_BUCKET_SIZE:
            # demote the oldest old entry back to new (addrbook.go
            # moveToOld's displacement path)
            members = [
                self._addrs[i]
                for i in self._old[bucket]
                if i in self._addrs
            ]
            victim = min(members, key=lambda k: k.last_success)
            self._remove_from_bucket_locked(victim, bucket)
            victim.bucket_type = BUCKET_TYPE_NEW
            nb = self._bucket_index(
                BUCKET_TYPE_NEW, _group(victim.addr),
                _group_of_src(self, victim.src_id),
            )
            self._place_new_locked(victim, nb)
        self._old[bucket].add(ka.addr.id)
        ka.buckets.append(bucket)

    def mark_bad(self, addr: NetAddress) -> None:
        self.remove_address(addr)

    # -- selection -------------------------------------------------------

    def pick_address(self, new_bias_pct: int = 50) -> NetAddress | None:
        """(addrbook.go:303 PickAddress) — random address, biased
        between the new and old partitions."""
        with self._mtx:
            new_ids = [
                i
                for i, ka in self._addrs.items()
                if not ka.is_old and not ka.is_bad()
            ]
            old_ids = [i for i, ka in self._addrs.items() if ka.is_old]
            if not new_ids and not old_ids:
                return None
            bias = max(0, min(100, new_bias_pct))
            use_new = old_ids == [] or (
                new_ids != [] and self._rng.random() * 100 < bias
            )
            pool = new_ids if use_new else old_ids
            return self._addrs[self._rng.choice(pool)].addr

    def get_selection(self) -> list[NetAddress]:
        """Random selection for a PEX response (addrbook.go:387
        GetSelection): ~23% of the book, clamped to [32, 250]."""
        with self._mtx:
            all_ids = list(self._addrs)
            if not all_ids:
                return []
            n = len(all_ids) * GET_SELECTION_PERCENT // 100
            n = max(min(n, MAX_GET_SELECTION), MIN_GET_SELECTION)
            n = min(n, len(all_ids))
            return [
                self._addrs[i].addr for i in self._rng.sample(all_ids, n)
            ]

    def need_more_addrs(self) -> bool:
        with self._mtx:
            return len(self._addrs) < 1000  # addrbook.go needAddressThreshold

    def is_good(self, addr: NetAddress) -> bool:
        with self._mtx:
            ka = self._addrs.get(addr.id)
            return ka is not None and ka.is_old

    def has_address(self, addr: NetAddress) -> bool:
        with self._mtx:
            return addr.id in self._addrs

    def empty(self) -> bool:
        with self._mtx:
            return not self._addrs

    def size(self) -> int:
        with self._mtx:
            return len(self._addrs)

    # -- hashing ---------------------------------------------------------

    def _bucket_index(
        self, bucket_type: str, group: str, src_group: str
    ) -> int:
        h = hashlib.sha256(
            f"{self._key}|{bucket_type}|{group}|{src_group}".encode()
        ).digest()
        n = int.from_bytes(h[:8], "big")
        if bucket_type == BUCKET_TYPE_NEW:
            return n % NEW_BUCKET_COUNT
        return n % OLD_BUCKET_COUNT

    # -- persistence (p2p/pex/file.go) -----------------------------------

    def save(self) -> None:
        with self._mtx:
            data = {
                "key": self._key,
                "addrs": [ka.to_json() for ka in self._addrs.values()],
            }
            self._dirty = False
        # serialize writers (periodic save vs on_stop) so two saves
        # can't interleave on the tmp file and persist torn JSON
        with self._save_mtx:
            tmp = self.file_path + ".tmp"
            os.makedirs(
                os.path.dirname(self.file_path) or ".", exist_ok=True
            )
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, self.file_path)

    def _load(self) -> None:
        if not os.path.exists(self.file_path):
            return
        try:
            with open(self.file_path) as f:
                data = json.load(f)
        except (OSError, ValueError) as exc:
            self.logger.error("corrupt addrbook file", err=repr(exc))
            return
        with self._mtx:
            self._key = data.get("key", self._key)
            for d in data.get("addrs", []):
                try:
                    ka = KnownAddress.from_json(d)
                except Exception:  # noqa: BLE001 — skip bad entries
                    continue
                self._addrs[ka.addr.id] = ka
                store = self._old if ka.is_old else self._new
                count = len(store)
                ka.buckets = [b % count for b in ka.buckets] or [
                    self._bucket_index(
                        ka.bucket_type, _group(ka.addr),
                        _group_of_src(self, ka.src_id),
                    )
                ]
                for b in ka.buckets:
                    store[b].add(ka.addr.id)
        self.logger.info("loaded addrbook", size=self.size())

    def _save_routine(self) -> None:
        while not self._quit.wait(_SAVE_INTERVAL):
            if self._dirty:
                try:
                    self.save()
                except OSError as exc:
                    self.logger.error(
                        "addrbook save failed", err=repr(exc)
                    )


def _group_of_src(book: AddrBook, src_id: str) -> str:
    ka = book._addrs.get(src_id)
    return _group(ka.addr) if ka is not None else src_id[:8]


__all__ = ["AddrBook", "AddrBookError", "KnownAddress"]
