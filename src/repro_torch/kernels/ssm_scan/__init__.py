"""Selective scan: ``csrc/ssm_scan.cu`` (the CUDA kernel), ``kernel.py`` (its
wrapper and plain version), ``ops.py`` (the public entry point) and
``ref.py`` (the sequential oracle)."""
