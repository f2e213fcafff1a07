"""Fault tolerance (``fault``): the port of ``repro/runtime/fault.py``."""
