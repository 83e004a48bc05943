"""Drivers: one module a kind of traffic, named by the ``driver`` key of a
traffic file; each exposes ``run(ctx) -> Outcome`` (harness/context.py)."""
