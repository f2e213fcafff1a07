"""Atomic, async checkpoints (``ckpt``): the port of
``repro/checkpoint``."""
