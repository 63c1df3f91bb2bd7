"""ChunkFormer on PyTorch and CUDA: the port of ``chunkformer_tpu`` to NVIDIA Hopper.

Masked-chunk Conformer CTC/AED models: long-form ``endless_decode``,
masked-batch ``batch_decode``, batch ``encode``, the streaming step, the CTC
and attention searches (``decode/``), multi-task classification
(``models/classification.py``), the decode, recognize, alignment, stream and
classify CLIs (``bin/``) and the training step, in plain PyTorch around hand-written CUDA kernels
(``csrc/``): relative-position chunk attention for decoding and for
training, and the Kaldi log-mel filterbank. The JAX package
``chunkformer_tpu`` is the reference; this package imports nothing from it.
"""

__version__ = "0.1.0"
