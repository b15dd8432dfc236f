"""Train and eval steps of the LM stack, as ``repro.train``."""
