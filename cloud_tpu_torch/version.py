"""Version of the PyTorch port (the port's ``cloud_tpu/version.py``)."""

__version__ = "0.1.0"
