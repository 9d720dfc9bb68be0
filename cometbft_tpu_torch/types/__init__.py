"""Domain types (a part of cometbft_tpu/types/, copied): Block, Vote,
Commit, ValidatorSet, VoteSet, canonical sign-bytes, the header and
commit codec, light blocks and commit verification.  The part set,
evidence, params and genesis are not ported yet."""

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
    "Data",
    "Header",
    "NIL_BLOCK_ID",
    "PRECOMMIT_TYPE",
    "PREVOTE_TYPE",
    "PROPOSAL_TYPE",
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
