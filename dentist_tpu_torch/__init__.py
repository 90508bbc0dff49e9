"""dentist_tpu_torch — the gap closer on PyTorch and CUDA (NVIDIA GPUs).

A port of :mod:`dentist_tpu` beside it, which needs nothing of that
package at run time.  The host pipeline is the JAX package's: the host
modules are copies at the same relative paths (``io``, ``sim``,
``utils``, ``config``, ``native``, ``cli``'s parser,
``ops/{seeding,chain}`` and the host models), the modules that reach the
device are ports.  The device work is hand-written CUDA kernels for
Hopper (``sm_90a``), each with a plain PyTorch version that the wrapper
uses for CPU tensors only:

- K1/K1p ``ops/banded.py`` + ``csrc/extend.cu`` — the banded extension
  DP behind tandem masking, self-alignment, read mapping and validation;
  K5 ``csrc/store_write.cu`` unpacks the 2-bit uploads of the device
  sequence store;
- K2/K2p/K2r ``ops/nw_round.py`` + ``csrc/nw_round.cu`` — the consensus
  realign round with on-device traceback, on unpacked, 2-bit packed or
  store-resident lanes;
- K4/K4w ``ops/round_pack.py`` + ``csrc/round_pack.cu`` — the rounds'
  sparse and dense result blocks;
- K3/K3p ``ops/nw_dist.py`` + ``csrc/nw_dist.cu`` — the polish scorer
  (bit-parallel: one thread per read slot, the read as 64-bit words).

``parallel/dp.py`` splits every dispatch over ``torch.distributed``
ranks, one per card.  Entry point: ``python -m dentist_tpu_torch
pipeline ASM READS OUT``.  This package never imports JAX.
"""

__version__ = "0.1.0"
