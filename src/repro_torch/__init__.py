"""PyTorch/CUDA port of the ISLA approximate-aggregation system.

The package mirrors ``repro`` module for module (``repro_torch.core``,
``repro_torch.kernels``, ``repro_torch.launch``) and imports ``torch``,
never ``jax``.  Its device path runs on ``cuda`` unless the caller passes
``device="cpu"``.
"""
