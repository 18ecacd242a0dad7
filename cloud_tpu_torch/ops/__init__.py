"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Import the modules themselves (``from cloud_tpu_torch.ops import
flash_attention``); this package does not rebind their names to
functions.
"""
