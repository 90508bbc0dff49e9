"""The port's compute path: the hand-written CUDA kernels with their
plain PyTorch versions (``banded``, ``nw_round``, ``round_pack``,
``nw_dist``, ``pack2``), the host drivers around them (``aligner``,
``mapper``, ``consensus``) and copies of the JAX package's host passes
(``seeding``, ``chain``)."""
