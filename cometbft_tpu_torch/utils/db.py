"""Embedded key-value storage (a copy of cometbft_tpu/utils/db.py;
reference analog: cometbft-db).

The reference sits every store (blocks, state, indexes, evidence, light)
on a small ordered-KV interface with pluggable backends (goleveldb
default, rocksdb/pebble optional).  We keep the same seam: an ordered
``DB`` interface with an in-memory backend for tests and a persistent
SQLite backend (stdlib, crash-safe WAL journaling) for nodes.  Storage
is host-side and never on the device path (SURVEY.md §2.9).

The reference's third backend, ``CometKVDB`` over its native
log-structured engine (``utils/kv_native.py``), is not ported yet:
``open_db(..., "cometkv")`` raises ``DBError``.  The locks are
``threading``'s (the reference's ``utils/sync`` debug modes are not
ported), and ``SQLiteDB.close`` lets a failed close raise where the
reference ignores it.
"""

from __future__ import annotations

import abc
import bisect
import sqlite3
import threading
from typing import Iterator

from cometbft_tpu_torch.utils import sync as cmtsync


class DBError(Exception):
    pass


class DB(abc.ABC):
    """Ordered byte-keyed store (cometbft-db types.go DB interface)."""

    @abc.abstractmethod
    def get(self, key: bytes) -> bytes | None: ...

    @abc.abstractmethod
    def set(self, key: bytes, value: bytes) -> None: ...

    @abc.abstractmethod
    def delete(self, key: bytes) -> None: ...

    @abc.abstractmethod
    def iterator(
        self, start: bytes | None = None, end: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes]]:
        """Ascending iteration over [start, end)."""

    @abc.abstractmethod
    def reverse_iterator(
        self, start: bytes | None = None, end: bytes | None = None
    ) -> Iterator[tuple[bytes, bytes]]:
        """Descending iteration over [start, end)."""

    @abc.abstractmethod
    def write_batch(self, ops: list[tuple[bytes, bytes | None]]) -> None:
        """Atomically apply (key, value) sets and (key, None) deletes."""

    @abc.abstractmethod
    def close(self) -> None: ...

    def compact(self) -> None:
        """Reclaim space (cometbft-db Compact; `compact-db` command).
        Default: nothing to do."""

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def prefix_iterator(self, prefix: bytes) -> Iterator[tuple[bytes, bytes]]:
        return self.iterator(prefix, prefix_end(prefix))


def prefix_end(prefix: bytes) -> bytes | None:
    """Smallest key greater than every key with this prefix."""
    if not prefix:
        return None
    buf = bytearray(prefix)
    for i in reversed(range(len(buf))):
        if buf[i] != 0xFF:
            buf[i] += 1
            return bytes(buf[: i + 1])
    return None  # prefix is all 0xFF: no upper bound


class MemDB(DB):
    """Sorted in-memory backend (cometbft-db memdb)."""

    def __init__(self):
        self._mtx = cmtsync.RMutex()
        self._keys: list[bytes] = []
        self._data: dict[bytes, bytes] = {}

    def get(self, key: bytes) -> bytes | None:
        with self._mtx:
            return self._data.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if not isinstance(value, (bytes, bytearray)):
            raise DBError("value must be bytes")
        with self._mtx:
            if key not in self._data:
                bisect.insort(self._keys, key)
            self._data[key] = bytes(value)

    def delete(self, key: bytes) -> None:
        with self._mtx:
            if key in self._data:
                del self._data[key]
                i = bisect.bisect_left(self._keys, key)
                del self._keys[i]

    def _range(self, start: bytes | None, end: bytes | None) -> list[bytes]:
        lo = bisect.bisect_left(self._keys, start) if start else 0
        hi = bisect.bisect_left(self._keys, end) if end else len(self._keys)
        return self._keys[lo:hi]

    def iterator(self, start=None, end=None):
        with self._mtx:
            keys = self._range(start, end)
        for k in keys:
            v = self.get(k)
            if v is not None:
                yield k, v

    def reverse_iterator(self, start=None, end=None):
        with self._mtx:
            keys = self._range(start, end)
        for k in reversed(keys):
            v = self.get(k)
            if v is not None:
                yield k, v

    def write_batch(self, ops):
        with self._mtx:
            for key, value in ops:
                if value is None:
                    self.delete(key)
                else:
                    self.set(key, value)

    def close(self) -> None:
        pass


class SQLiteDB(DB):
    """Persistent backend on stdlib sqlite3 with WAL journaling.

    Plays goleveldb's role in the reference (default `db_backend`,
    docs/references/config/config.toml.md:117): an ordered, crash-safe
    embedded store with atomic batches.  BLOB keys preserve bytewise
    order, so range iteration matches MemDB exactly.
    """

    def __init__(self, path: str):
        self._path = path
        self._local = threading.local()
        self._conns: list[sqlite3.Connection] = []
        self._conns_mtx = cmtsync.Mutex()
        conn = self._conn()
        with conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS kv"
                " (k BLOB PRIMARY KEY, v BLOB NOT NULL) WITHOUT ROWID"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            # check_same_thread=False so close() can tear down every
            # connection regardless of which thread created it; each
            # thread still uses its own connection for isolation.
            conn = sqlite3.connect(
                self._path, timeout=30.0, check_same_thread=False
            )
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
            with self._conns_mtx:
                self._conns.append(conn)
        return conn

    def get(self, key: bytes) -> bytes | None:
        row = self._conn().execute(
            "SELECT v FROM kv WHERE k = ?", (key,)
        ).fetchone()
        return bytes(row[0]) if row else None

    def set(self, key: bytes, value: bytes) -> None:
        conn = self._conn()
        with conn:
            conn.execute(
                "INSERT INTO kv (k, v) VALUES (?, ?)"
                " ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                (key, bytes(value)),
            )

    def delete(self, key: bytes) -> None:
        conn = self._conn()
        with conn:
            conn.execute("DELETE FROM kv WHERE k = ?", (key,))

    def _iter(self, start, end, desc: bool):
        clauses, params = [], []
        if start is not None:
            clauses.append("k >= ?")
            params.append(start)
        if end is not None:
            clauses.append("k < ?")
            params.append(end)
        where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
        order = "DESC" if desc else "ASC"
        cur = self._conn().execute(
            f"SELECT k, v FROM kv {where} ORDER BY k {order}", params
        )
        for k, v in cur:
            yield bytes(k), bytes(v)

    def iterator(self, start=None, end=None):
        return self._iter(start, end, desc=False)

    def reverse_iterator(self, start=None, end=None):
        return self._iter(start, end, desc=True)

    def write_batch(self, ops):
        conn = self._conn()
        with conn:
            for key, value in ops:
                if value is None:
                    conn.execute("DELETE FROM kv WHERE k = ?", (key,))
                else:
                    conn.execute(
                        "INSERT INTO kv (k, v) VALUES (?, ?)"
                        " ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                        (key, bytes(value)),
                    )

    def compact(self) -> None:
        """VACUUM: rebuild the file, reclaiming deleted-row space
        (what goleveldb compaction does for the reference)."""
        conn = self._conn()
        conn.commit()
        conn.execute("VACUUM")

    def close(self) -> None:
        with self._conns_mtx:
            for conn in self._conns:
                conn.close()
            self._conns.clear()
        self._local = threading.local()


def open_db(name: str, backend: str = "memdb", dir_: str = ".") -> DB:
    """Backend dispatch (cometbft-db NewDB)."""
    if backend == "memdb":
        return MemDB()
    if backend == "sqlite":
        import os

        os.makedirs(dir_, exist_ok=True)
        return SQLiteDB(os.path.join(dir_, f"{name}.db"))
    if backend == "cometkv":
        raise DBError("db backend 'cometkv' is not ported yet")
    raise DBError(f"unknown db backend {backend!r}")
