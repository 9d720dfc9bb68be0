"""Domain types (a copy of cometbft_tpu/types/ but its event bus):
Block, Vote, Commit, ValidatorSet, VoteSet, PartSet, BlockMeta, evidence,
params, genesis, canonical sign-bytes, the wire codec, light blocks and
commit verification.  ``types/event_bus.py`` comes with state
execution."""

from cometbft_tpu_torch.types.block import (
    BLOCK_ID_FLAG_ABSENT,
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    Block,
    BlockID,
    Commit,
    CommitSig,
    Data,
    Header,
    NIL_BLOCK_ID,
    PartSetHeader,
    tx_hash,
)
from cometbft_tpu_torch.types.canonical import (
    PRECOMMIT_TYPE,
    PREVOTE_TYPE,
    PROPOSAL_TYPE,
)
from cometbft_tpu_torch.types.evidence import (
    DuplicateVoteEvidence,
    LightClientAttackEvidence,
)
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.params import ConsensusParams, DEFAULT_CONSENSUS_PARAMS
from cometbft_tpu_torch.types.part_set import Part, PartSet
from cometbft_tpu_torch.types.validation import (
    verify_commit,
    verify_commit_light,
    verify_commit_light_trusting,
)
from cometbft_tpu_torch.types.validator import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import Proposal, Vote
from cometbft_tpu_torch.types.vote_set import (
    ConflictingVoteError,
    VoteSet,
    vote_set_for_precommit,
    vote_set_for_prevote,
)

__all__ = [
    "BLOCK_ID_FLAG_ABSENT",
    "BLOCK_ID_FLAG_COMMIT",
    "BLOCK_ID_FLAG_NIL",
    "Block",
    "BlockID",
    "Commit",
    "CommitSig",
    "ConflictingVoteError",
    "ConsensusParams",
    "DEFAULT_CONSENSUS_PARAMS",
    "Data",
    "DuplicateVoteEvidence",
    "GenesisDoc",
    "GenesisValidator",
    "Header",
    "LightClientAttackEvidence",
    "NIL_BLOCK_ID",
    "PRECOMMIT_TYPE",
    "PREVOTE_TYPE",
    "PROPOSAL_TYPE",
    "Part",
    "PartSet",
    "PartSetHeader",
    "Proposal",
    "Validator",
    "ValidatorSet",
    "Vote",
    "VoteSet",
    "tx_hash",
    "verify_commit",
    "verify_commit_light",
    "verify_commit_light_trusting",
    "vote_set_for_precommit",
    "vote_set_for_prevote",
]
