"""``python -m dentist_tpu_torch pipeline ASM READS OUT [options]``.

The command line of the JAX package's CLI (:mod:`.cli`) (its parser, prefix matching,
``--config`` files and log levels) with the ``pipeline`` sub-command run
by the port on the GPU.  The other sub-commands are not ported yet and
exit with an error.

On several GPUs, start one process per card with
``DENTIST_TPU_COORDINATOR=host:port`` (rank 0's address),
``DENTIST_TPU_NUM_PROCESSES`` and ``DENTIST_TPU_PROCESS_ID`` set: each
process takes card ``rank mod (cards on its host)``, the ranks join an
NCCL group, and rank 0 writes the output.
"""

from __future__ import annotations

import sys

from .cli import build_parser, resolve_command
from .config import apply_config, load_config
from .device import set_device
from .parallel.dp import rank_device
from .utils.log import set_log_level

__all__ = ["main"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and not argv[0].startswith("-"):
        argv[0] = resolve_command(argv[0])
    parser = build_parser()
    parser.prog = "python -m dentist_tpu_torch"
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 2
    if args.command != "pipeline":
        print(f"{args.command}: not yet ported to dentist_tpu_torch",
              file=sys.stderr)
        return 2
    if args.quiet:
        set_log_level("error")
    elif args.verbose >= 2:
        set_log_level("debug")
    elif args.verbose == 1:
        set_log_level("diagnostic")
    if args.config:
        sp = parser.subparser_registry[args.command]
        positional = {a.dest for a in sp._get_positional_actions()}
        explicit = {a.split("=")[0].lstrip("-").replace("-", "_") for a in argv}
        apply_config(args, load_config(args.config), args.command, explicit,
                     positional)
    if args.revert:
        raise SystemExit("--revert is not supported by dentist_tpu_torch yet")
    set_device(rank_device())

    from .pipeline import PipelineConfig, run_pipeline

    cfg = PipelineConfig(
        read_coverage=args.read_coverage,
        max_coverage_self=args.max_coverage_self,
        min_spanning_reads=args.min_spanning_reads,
        min_anchor_length=args.min_anchor_length,
        join_policy=args.join_policy,
        max_insertion_error=args.max_insertion_error,
        no_validation=args.no_validation,
        allow_single_reads=args.allow_single_reads,
        workdir=args.workdir,
        ploidy=args.ploidy,
        max_alignment_error=args.max_alignment_error,
        best_pileup_margin=args.best_pile_up_margin,
        existing_gap_bonus=args.existing_gap_bonus,
        min_reads_per_pile_up=args.min_reads_per_pile_up,
        proper_allowance=args.proper_alignment_allowance,
        resume=not args.no_resume,
    )
    run_pipeline(args.assembly, args.reads, args.out_assembly, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
