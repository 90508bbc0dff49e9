"""The port's compute path: the three hand-written CUDA kernels with
their plain PyTorch versions (``banded``, ``nw_round``, ``nw_dist``) and
the host drivers around them (``aligner``, ``mapper``, ``consensus``)."""
