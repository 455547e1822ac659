"""Utilities of the runtime: tracing spans (``tracing``) and the collectives'
point-to-point ring transport (``collective``). Actor pools and placement
groups are not ported yet."""
