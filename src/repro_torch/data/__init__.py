"""The deterministic synthetic token pipeline (``pipeline``): the port of
``repro/data``."""
