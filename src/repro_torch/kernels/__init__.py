"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions
(``ref.py``) and the device-routed dispatch (``ops.py``)."""
