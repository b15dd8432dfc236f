"""Token pipelines of the LM stack, as ``repro.data``."""
