"""Checkpoints of the training engine: ``engine.py`` (save, load, async
save, verified fallback, auto-resume), ``tensorfile.py`` (the safetensors
layout the state files use) and ``to_fp32.py`` (the ``dstpu_torch_to_fp32``
converter)."""
