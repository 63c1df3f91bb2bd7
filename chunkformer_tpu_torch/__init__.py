"""ChunkFormer on PyTorch and CUDA: the port of ``chunkformer_tpu`` to NVIDIA Hopper.

Masked-chunk Conformer CTC decoding (long-form ``endless_decode`` and
masked-batch ``batch_decode``) in plain PyTorch around two hand-written
CUDA kernels (``csrc/``): relative-position chunk attention and the Kaldi
log-mel filterbank. The JAX package ``chunkformer_tpu`` is the reference;
this package imports nothing from it.
"""

__version__ = "0.1.0"
