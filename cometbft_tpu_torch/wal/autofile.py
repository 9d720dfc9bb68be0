"""Size-rotated append-only file groups (a copy of
cometbft_tpu/wal/autofile.py; reference: internal/autofile/group.go:56).

The WAL sits on a ``Group``: an append head file plus rotated chunks
``<head>.000``, ``<head>.001``, … .  Writers only touch the head;
rotation renames it to the next index.  Readers iterate chunks in index
order then the head, so a record stream spans rotations transparently.
A total-size limit prunes the oldest chunks (group.go checkTotalSizeLimit).
Its lock is ``utils/sync``'s ``Mutex()``.
"""

from __future__ import annotations

import os
import re
import threading
from cometbft_tpu_torch.utils import sync as cmtsync

DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024  # group.go:26
DEFAULT_TOTAL_SIZE_LIMIT = 1024 * 1024 * 1024  # group.go:27


class Group:
    def __init__(
        self,
        head_path: str,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        total_size_limit: int = DEFAULT_TOTAL_SIZE_LIMIT,
    ):
        self.head_path = head_path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self._mtx = cmtsync.Mutex()
        os.makedirs(os.path.dirname(head_path) or ".", exist_ok=True)
        self._head = open(head_path, "ab")
        self._min_index, self._max_index = self._scan_indexes()

    def _scan_indexes(self) -> tuple[int, int]:
        """Existing chunk indexes on disk (group.go readGroupInfo)."""
        dir_ = os.path.dirname(self.head_path) or "."
        base = os.path.basename(self.head_path)
        pat = re.compile(re.escape(base) + r"\.(\d{3,})$")
        indexes = sorted(
            int(m.group(1))
            for name in os.listdir(dir_)
            if (m := pat.match(name))
        )
        if not indexes:
            return 0, -1
        return indexes[0], indexes[-1]

    def chunk_path(self, index: int) -> str:
        return f"{self.head_path}.{index:03d}"

    # -- writing ---------------------------------------------------------

    def write(self, data: bytes) -> None:
        with self._mtx:
            self._head.write(data)

    def flush(self) -> None:
        with self._mtx:
            self._head.flush()

    def sync(self) -> None:
        with self._mtx:
            self._head.flush()
            os.fsync(self._head.fileno())  # blocking ok: wal_fsync — the group-head durability barrier the stage measures

    def head_size(self) -> int:
        with self._mtx:
            self._head.flush()
            return os.path.getsize(self.head_path)

    def maybe_rotate(self) -> bool:
        """Rotate the head if over the size limit (group.go checkHeadSizeLimit);
        then enforce the total size limit.  Returns True if rotated."""
        rotated = False
        with self._mtx:
            self._head.flush()
            if os.path.getsize(self.head_path) >= self.head_size_limit:
                self._rotate_locked()
                rotated = True
            self._check_total_size_locked()
        return rotated

    def rotate(self) -> None:
        with self._mtx:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        self._head.flush()
        os.fsync(self._head.fileno())  # blocking ok: wal_fsync — rotation seals the retiring head; height-boundary only
        self._head.close()
        self._max_index += 1
        os.replace(self.head_path, self.chunk_path(self._max_index))
        self._head = open(self.head_path, "ab")  # blocking ok: wal_fsync — reopening the head after rotation; height-boundary only

    def _check_total_size_locked(self) -> None:
        if self.total_size_limit <= 0:
            return
        while self._min_index <= self._max_index:
            total = sum(
                os.path.getsize(p) for p in self._paths_locked() if os.path.exists(p)
            )
            if total <= self.total_size_limit:
                return
            oldest = self.chunk_path(self._min_index)
            if os.path.exists(oldest):
                os.unlink(oldest)
            self._min_index += 1

    # -- reading ---------------------------------------------------------

    def _paths_locked(self) -> list[str]:
        paths = [
            self.chunk_path(i)
            for i in range(self._min_index, self._max_index + 1)
        ]
        paths.append(self.head_path)
        return paths

    def paths(self) -> list[str]:
        """Chunk paths oldest→newest, head last."""
        with self._mtx:
            return self._paths_locked()

    def read_all(self) -> bytes:
        """The full record stream across rotations."""
        self.flush()
        out = bytearray()
        for p in self.paths():
            if os.path.exists(p):
                with open(p, "rb") as f:
                    out += f.read()
        return bytes(out)

    def truncate_all(self) -> None:
        """Drop every chunk and reset the head (tests / wal reset)."""
        with self._mtx:
            self._head.close()
            for i in range(self._min_index, self._max_index + 1):
                p = self.chunk_path(i)
                if os.path.exists(p):
                    os.unlink(p)
            self._min_index, self._max_index = 0, -1
            self._head = open(self.head_path, "wb")

    def close(self) -> None:
        with self._mtx:
            self._head.flush()
            try:
                os.fsync(self._head.fileno())
            except OSError:
                pass
            self._head.close()
