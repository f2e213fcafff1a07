"""Simulator and protocol core of the port (counterpart of ``repro.core``)."""
