"""Consensus plane — the Tendermint BFT state machine, its timeout
scheduler, wire messages, vote bookkeeping, and crash-recovery replay
(a copy of cometbft_tpu/consensus/__init__.py; reference:
internal/consensus/).  The reactor is ``consensus.reactor``, as in the
reference."""

from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
from cometbft_tpu_torch.consensus.messages import (
    BlockPartMessage,
    HasVoteMessage,
    NewRoundStepMessage,
    NewValidBlockMessage,
    ProposalMessage,
    ProposalPOLMessage,
    VoteMessage,
    VoteSetBitsMessage,
    VoteSetMaj23Message,
    decode_message,
    encode_message,
)
from cometbft_tpu_torch.consensus.replay import Handshaker, HandshakeError
from cometbft_tpu_torch.consensus.state import ConsensusError, ConsensusState, MsgInfo
from cometbft_tpu_torch.consensus.ticker import (
    STEP_COMMIT,
    STEP_NEW_HEIGHT,
    STEP_NEW_ROUND,
    STEP_PRECOMMIT,
    STEP_PRECOMMIT_WAIT,
    STEP_PREVOTE,
    STEP_PREVOTE_WAIT,
    STEP_PROPOSE,
    TimeoutInfo,
    TimeoutTicker,
)

__all__ = [
    "BlockPartMessage",
    "ConsensusError",
    "ConsensusState",
    "Handshaker",
    "HandshakeError",
    "HasVoteMessage",
    "HeightVoteSet",
    "MsgInfo",
    "NewRoundStepMessage",
    "NewValidBlockMessage",
    "ProposalMessage",
    "ProposalPOLMessage",
    "STEP_COMMIT",
    "STEP_NEW_HEIGHT",
    "STEP_NEW_ROUND",
    "STEP_PRECOMMIT",
    "STEP_PRECOMMIT_WAIT",
    "STEP_PREVOTE",
    "STEP_PREVOTE_WAIT",
    "STEP_PROPOSE",
    "TimeoutInfo",
    "TimeoutTicker",
    "VoteMessage",
    "VoteSetBitsMessage",
    "VoteSetMaj23Message",
    "decode_message",
    "encode_message",
]
