"""Optimizers of the LM stack, as ``repro.optim``."""
