"""The optimizer (``adamw``) and gradient compression with error feedback
(``compress``): the port of ``repro/optim``."""
