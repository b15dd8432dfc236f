"""Checkpoints of the LM stack, as ``repro.checkpoint``."""
