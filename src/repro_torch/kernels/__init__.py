"""The port's hand-written CUDA kernels (``csrc/``), their launch
wrappers, their plain PyTorch versions (``ref``) and the dispatchers the
engine calls (``ops``)."""
