"""The batch scheduler and the transactional page store — the port of
``repro/sched/``."""
