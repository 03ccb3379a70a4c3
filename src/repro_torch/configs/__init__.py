"""Configurations (copies of the reference's ``repro.configs``)."""
