"""Model-level entry points of the port (the counterpart of
cometbft_tpu/models): commit verification as one forward step."""
