"""PyTorch/CUDA port of latte_tpu for one NVIDIA H100.

The JAX package ``latte_tpu`` stays the reference; this package mirrors its
layout (``config``, ``models``, ``kernels``, ``core``, ``quant``,
``sample``, ``train``, ``data``, ``vae``) so each module has a counterpart
there.
Every Pallas kernel of the JAX package is a CUDA C++ kernel under ``csrc/``,
built with nvcc at first use and bound with ctypes (``kernels/build.py``).
Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
