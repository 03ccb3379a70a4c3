"""Flash-attention forward: ``csrc/flash_fwd.cu`` (the CUDA kernel),
``kernel.py`` (its wrapper and plain version), ``ops.py`` (the public entry
point) and ``ref.py`` (the O(S·T) oracle)."""
