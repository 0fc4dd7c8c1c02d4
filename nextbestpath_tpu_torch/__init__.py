"""nextbestpath_tpu_torch: the PyTorch/CUDA port of nextbestpath_tpu.

A second package beside the JAX one. It imports torch and numpy only; the
three ray and coverage kernels the JAX package wrote in Pallas, and the
planner's distance field and path walk, are CUDA C++ for Hopper
(``csrc/``), built with one ``nvcc`` call and bound with ctypes
(``kernels.py``). Every entry point takes ``device=``, which defaults to
``"cuda"``; tensors on the CPU take each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
