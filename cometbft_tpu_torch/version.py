"""Version constants (a copy of cometbft_tpu/version.py; reference:
version/version.go:5-24)."""

# Semantic version of this framework.
__version__ = "0.1.0"

# Protocol versions, kept capability-compatible with the reference
# (version/version.go): block protocol 11, p2p protocol 9, ABCI 2.1.0.
BLOCK_PROTOCOL = 11
P2P_PROTOCOL = 9
ABCI_SEMVER = "2.1.0"
