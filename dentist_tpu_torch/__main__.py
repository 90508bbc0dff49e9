"""``python -m dentist_tpu_torch <sub-command> [options]``: the port's
command line (:func:`dentist_tpu_torch.cli.main`).

The sub-commands that reach the GPU (``tandem``, ``align``, ``map``,
``collect-pile-ups``, ``process-pile-ups``, ``pipeline``) always run on
a card.  On several GPUs, start one process per card with
``DENTIST_TPU_COORDINATOR=host:port`` (rank 0's address),
``DENTIST_TPU_NUM_PROCESSES`` and ``DENTIST_TPU_PROCESS_ID`` set: each
process takes card ``rank mod (cards on its host)``; ``pipeline`` joins
the ranks in an NCCL group, and rank 0 writes the output.
"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
