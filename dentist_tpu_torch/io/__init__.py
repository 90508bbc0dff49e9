"""I/O edges: FASTA/BED/AGP, 2-bit packing, Dazzler-format import/export.

Reference counterpart: ``source/dentist/util/fasta.d``, the DB/LAS/mask
binary formats in ``source/dentist/dazzler.d``, and the writers in
``source/dentist/commands/output.d``.
"""
