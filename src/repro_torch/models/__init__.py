"""The language model of the dense and RWKV families (the port of
``repro/models``): ``LM``, its blocks, and the weight converter."""
from .lm import LM  # noqa: F401
