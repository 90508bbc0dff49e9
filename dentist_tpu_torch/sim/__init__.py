"""Simulation harness: synthetic genomes, long reads, gapped assemblies.

Reference counterpart: the Dazzler ``simulator``/``rangen`` binaries
(test-only dependencies, ``tests/test-commands.sh:7-13``) and the
testing-only ``build-partial-assembly`` command
(``source/dentist/commands/buildPartialAssembly.d``).
"""

from .genome import random_genome, insert_repeats
from .reads import simulate_reads, ReadGroundTruth
from .partial import build_partial_assembly
