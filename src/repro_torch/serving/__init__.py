"""Serving metrics (a copy of the reference's ``repro.serving.metrics``).

Clock-free: time enters only through injected ``clock=`` callables."""
