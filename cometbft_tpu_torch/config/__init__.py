"""Node configuration, the parts consensus and the mempool read (a part
of cometbft_tpu/config/__init__.py: 11-47, 142-154, 175-203 and
462-480; reference: config/config.go).

Durations are nanosecond ints, as in the rest of the codebase; the
human-friendly "300ms"/"10s" strings parse with ``parse_duration_ns``.

Where the port departs from its reference: there is no ``Config`` tree,
no TOML and no other section yet (they come with the node).
``test_config`` returns the two sections this module has, with the
reference's fast test timeouts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_NS = {
    "ns": 1,
    "us": 10**3,
    "ms": 10**6,
    "s": 10**9,
    "m": 60 * 10**9,
    "h": 3600 * 10**9,
}


class ConfigError(Exception):
    pass


def parse_duration_ns(s: str | int) -> int:
    """Parse Go-style duration strings ("1.5s", "500ms", "1m30s")."""
    if isinstance(s, int):
        return s
    total, pos = 0, 0
    s = s.strip()
    if s in ("0", ""):
        return 0
    for m in re.finditer(r"(\d+(?:\.\d+)?)(ns|us|ms|s|m|h)", s):
        if m.start() != pos:
            raise ConfigError(f"invalid duration {s!r}")
        total += int(float(m.group(1)) * _NS[m.group(2)])
        pos = m.end()
    if pos != len(s):
        raise ConfigError(f"invalid duration {s!r}")
    return total


@dataclass
class MempoolConfig:
    """(config/config.go MempoolConfig)"""

    type: str = "flood"  # flood | nop
    recheck: bool = True
    recheck_timeout_ns: int = 10**9
    broadcast: bool = True
    size: int = 5000
    max_txs_bytes: int = 1073741824
    cache_size: int = 10000
    keep_invalid_txs_in_cache: bool = False
    max_tx_bytes: int = 1048576


@dataclass
class ConsensusConfig:
    """Timeouts that bound throughput (config/config.go:1233-1237)."""

    wal_file: str = "data/cs.wal/wal"
    timeout_propose_ns: int = 3 * 10**9
    timeout_propose_delta_ns: int = 500 * 10**6
    # v1.0 merged the prevote/precommit timeout pairs into one vote
    # timeout (config.go:1211 TimeoutVote)
    timeout_vote_ns: int = 10**9
    timeout_vote_delta_ns: int = 500 * 10**6
    timeout_commit_ns: int = 10**9
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval_ns: int = 0
    peer_gossip_sleep_duration_ns: int = 100 * 10**6
    peer_query_maj23_sleep_duration_ns: int = 2 * 10**9
    # refuse to join consensus when our own signature appears in the
    # last N seen commits (config.go DoubleSignCheckHeight; 0 = off)
    double_sign_check_height: int = 0

    def propose_timeout_ns(self, round_: int) -> int:
        return self.timeout_propose_ns + self.timeout_propose_delta_ns * round_

    def prevote_timeout_ns(self, round_: int) -> int:
        return self.timeout_vote_ns + self.timeout_vote_delta_ns * round_

    def precommit_timeout_ns(self, round_: int) -> int:
        return self.timeout_vote_ns + self.timeout_vote_delta_ns * round_


@dataclass
class Sections:
    """The sections of the reference's ``Config`` that this module has."""

    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)


def default_config() -> Sections:
    return Sections()


def test_config() -> Sections:
    """Fast timeouts for tests (config/config.go TestConfig)."""
    cfg = default_config()
    cfg.consensus = ConsensusConfig(
        timeout_propose_ns=80 * 10**6,
        timeout_propose_delta_ns=1 * 10**6,
        timeout_vote_ns=20 * 10**6,
        timeout_vote_delta_ns=1 * 10**6,
        timeout_commit_ns=20 * 10**6,
        peer_gossip_sleep_duration_ns=5 * 10**6,
        peer_query_maj23_sleep_duration_ns=250 * 10**6,
    )
    cfg.mempool.recheck_timeout_ns = 10 * 10**6
    return cfg


# not a test: pytest must not collect the helper when a test imports it
test_config.__test__ = False


__all__ = [
    "ConfigError",
    "ConsensusConfig",
    "MempoolConfig",
    "Sections",
    "default_config",
    "parse_duration_ns",
    "test_config",
]
