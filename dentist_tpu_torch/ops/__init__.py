"""The port's compute path: the three hand-written CUDA kernels, each in
an unpacked and a 2-bit packed mode, with their plain PyTorch versions
(``banded``, ``nw_round``, ``nw_dist``, ``pack2``) and the host drivers
around them (``aligner``, ``mapper``, ``consensus``)."""
