"""PyTorch/CUDA port of the ISLA approximate-aggregation system.

The package mirrors ``repro`` module for module (``repro_torch.core``,
``repro_torch.kernels``, ``repro_torch.launch``, the LM serving path in
``repro_torch.configs``, ``repro_torch.models`` and ``repro_torch.serve``,
and its training path in ``repro_torch.train``) and imports ``torch``, never ``jax``.  Its device
path runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
