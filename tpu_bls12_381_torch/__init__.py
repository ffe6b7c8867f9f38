"""tpu-bls12-381, the PyTorch/CUDA port: BLS12-381 primitives on an NVIDIA GPU.

The package sits beside the JAX package of this repository and mirrors its
layout module by module.  Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas is a CUDA C++ kernel under ``csrc/``, built with
``nvcc`` at first use and loaded with ``ctypes``.  Nothing is built, and no
device is touched, when the package is imported.
"""

from . import constants
from .fields import FQ, FR

__version__ = "0.1.0"

__all__ = ["constants", "FQ", "FR", "__version__"]
