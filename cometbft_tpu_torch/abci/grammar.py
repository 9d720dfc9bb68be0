"""ABCI call-order grammar checking (a copy of
cometbft_tpu/abci/grammar.py; reference: test/e2e/pkg/grammar/checker.go,
spec/abci/abci++_comet_expected_behavior.md).

BFT bugs often surface as protocol-order violations long before they
corrupt state: InitChain re-sent after recovery, FinalizeBlock without
a Commit, snapshot chunks applied before an offer, heights applied out
of order.  ``RecordingApp`` wraps any Application and logs the
consensus/statesync call sequence; ``check_grammar`` validates it
against the protocol grammar:

  start         := clean-start | recovery
  clean-start   := init_chain consensus-exec
                 | state-sync consensus-exec
  recovery      := consensus-exec
  state-sync    := offer_snapshot+ apply_snapshot_chunk*
  consensus-exec:= height+
  height        := round* finalize_block commit
  round         := prepare_proposal | process_proposal
                 | extend_vote | verify_vote_extension

plus the semantic rules the grammar alone cannot express: FinalizeBlock
heights are strictly consecutive, and every FinalizeBlock is followed
by exactly one Commit before the next height begins.
"""

from __future__ import annotations

from cometbft_tpu_torch.abci.types import Application
from cometbft_tpu_torch.utils import sync as cmtsync

#: calls the grammar tracks (consensus + statesync connections); the
#: info/mempool connections (echo/info/query/check_tx) interleave
#: freely and are not order-constrained by the protocol.
TRACKED = frozenset(
    {
        "init_chain",
        "prepare_proposal",
        "process_proposal",
        "extend_vote",
        "verify_vote_extension",
        "finalize_block",
        "commit",
        "offer_snapshot",
        "apply_snapshot_chunk",
    }
)

_ROUND = {
    "prepare_proposal",
    "process_proposal",
    "extend_vote",
    "verify_vote_extension",
}


class GrammarError(Exception):
    """The observed ABCI call sequence violates the protocol grammar."""

    def __init__(self, msg: str, calls, index: int | None = None):
        where = f" at call #{index} ({calls[index][0]})" if (
            index is not None and index < len(calls)
        ) else ""
        super().__init__(
            msg + where + f"; sequence: {[c[0] for c in calls[:50]]}"
        )
        self.calls = calls
        self.index = index


def check_grammar(calls, clean_start: bool) -> None:
    """``calls``: list of (name, height) pairs — height is the request
    height for finalize_block/init_chain, else 0.  Raises GrammarError
    on the first violation."""
    i = 0
    n = len(calls)

    def name(j):
        return calls[j][0]

    if clean_start:
        if i >= n:
            raise GrammarError("empty sequence on clean start", calls)
        if name(i) == "init_chain":
            i += 1
        elif name(i) == "offer_snapshot":
            # snapshots may be retried: offer/apply interleave freely
            # as long as chunks follow at least one offer (checker.go
            # allows restarting state sync after a failed snapshot)
            while i < n and name(i) in (
                "offer_snapshot",
                "apply_snapshot_chunk",
            ):
                i += 1
        else:
            raise GrammarError(
                "clean start must begin with init_chain or state sync",
                calls,
                i,
            )
    else:
        if i < n and name(i) == "init_chain":
            raise GrammarError(
                "init_chain must not be re-sent on recovery", calls, i
            )

    # consensus-exec: height+
    heights_seen = 0
    last_height: int | None = None
    while i < n:
        # round*
        while i < n and name(i) in _ROUND:
            i += 1
        if i >= n:
            break  # trailing proposal rounds with no decision yet: fine
        if name(i) != "finalize_block":
            raise GrammarError(
                "expected finalize_block after proposal rounds", calls, i
            )
        h = calls[i][1]
        if last_height is not None and h != last_height + 1:
            raise GrammarError(
                f"finalize_block height {h} after {last_height} "
                "(must be consecutive)",
                calls,
                i,
            )
        last_height = h
        i += 1
        if i >= n:
            break  # crashed between FinalizeBlock and Commit: legal
        if name(i) != "commit":
            raise GrammarError(
                "finalize_block must be followed by commit", calls, i
            )
        i += 1
        heights_seen += 1


class RecordingApp:
    """Wraps an Application, recording the tracked call sequence
    (thread-safe; the node serializes consensus calls but mempool
    checks run concurrently).  Deliberately NOT an Application
    subclass: inherited default methods would shadow __getattr__ and
    silently bypass recording."""

    def __init__(self, inner: Application):
        self.inner = inner
        self.calls: list[tuple[str, int]] = []
        self._mtx = cmtsync.Mutex()

    def _record(self, method: str, req) -> None:
        if method in TRACKED:
            height = getattr(req, "height", 0) if req is not None else 0
            if method == "init_chain":
                height = getattr(req, "initial_height", 0)
            with self._mtx:
                self.calls.append((method, int(height or 0)))

    def __getattr__(self, method: str):
        fn = getattr(self.inner, method)
        if not callable(fn) or method.startswith("_"):
            return fn

        def wrapper(*args, **kwargs):
            self._record(method, args[0] if args else None)
            return fn(*args, **kwargs)

        return wrapper

    def check(self, clean_start: bool) -> None:
        with self._mtx:
            calls = list(self.calls)
        check_grammar(calls, clean_start)
