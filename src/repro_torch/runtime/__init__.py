"""Fault tolerance (``fault``), elastic re-meshing (``elastic``) and
straggler policies (``stragglers``): the port of ``repro/runtime/``."""
