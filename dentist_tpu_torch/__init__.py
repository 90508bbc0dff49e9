"""dentist_tpu_torch — the gap closer on PyTorch and CUDA (NVIDIA GPUs).

A port of :mod:`dentist_tpu` beside it.  The host pipeline is the JAX
package's (modules that never touch the device are imported from
``dentist_tpu`` rather than copied); the device work is three CUDA
kernels written by hand for Hopper (``sm_90a``), each with a 2-bit
packed-input mode (``csrc/pack2.cuh``) and a plain PyTorch version that
the wrapper uses for CPU tensors only:

- K1/K1p ``ops/banded.py`` + ``csrc/extend.cu`` — the banded extension
  DP behind tandem masking, self-alignment, read mapping and validation;
- K2/K2p ``ops/nw_round.py`` + ``csrc/nw_round.cu`` — the consensus
  realign round with on-device traceback;
- K3/K3p ``ops/nw_dist.py`` + ``csrc/nw_dist.cu`` — the polish scorer.

``parallel/dp.py`` splits every dispatch over ``torch.distributed``
ranks, one per card.  Entry point: ``python -m dentist_tpu_torch
pipeline ASM READS OUT``.  This package never imports JAX.
"""

__version__ = "0.1.0"
