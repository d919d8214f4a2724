"""diffusioniqt_tpu_torch — the PyTorch/CUDA port of ``diffusioniqt_tpu``.

Patch-based 3D conditional diffusion for Image Quality Transfer (low-field
to high-field brain MRI), served on an NVIDIA H100. The JAX package
``diffusioniqt_tpu`` is the reference; this package never imports it (nor
JAX), and mirrors its module layout so each module has a counterpart there.

Layout convention, as in the JAX package: volumes are channels-last
``(B, X, Y, Z, C)``, and a split 96^3 patch is 27 sub-volumes in the order
``b = (gx*f + gy)*f + gz``. The 3^3 convolutions of the main path run
through hand-written CUDA kernels (``ops/kernels``); their plain PyTorch
versions serve CPU tensors.
"""

__version__ = "0.1.0"
