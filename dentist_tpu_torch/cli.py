"""Command-line parser of the port.

Copied from ``dentist_tpu/cli.py``: the sub-command names, their
unambiguous-prefix matching (:func:`resolve_command`) and the argument
definitions (:func:`build_parser`), so the port's command line parses
exactly as the JAX package's.  ``python -m dentist_tpu_torch`` runs the
``pipeline`` sub-command; the handlers of the others are not ported
yet.
"""

from __future__ import annotations

import argparse

from . import __version__

#: every sub-command of the JAX package's CLI, in its order
COMMANDS: dict[str, None] = dict.fromkeys([
    "dust", "tandem", "align", "map", "mask-repetitive-regions",
    "propagate-mask", "merge-masks", "filter-mask", "show-mask", "bed2mask",
    "mask2bed", "chain-local-alignments", "collect-pile-ups", "show-pile-ups",
    "process-pile-ups", "show-insertions", "merge-insertions", "output",
    "translate-coords", "validate-regions", "export-las", "import-las",
    "export-mask", "import-mask", "intrinsic-qv", "lost-gaps", "fasta2db",
    "fasta2dam", "dbshow", "generate-config", "check-scaffolding",
    "validate-config", "simulate-reads", "build-partial-assembly",
    "find-closable-gaps", "check-results", "pipeline",
])


ALIASES = {
    "mask": "mask-repetitive-regions",  # reference short name; `mask2bed`
    "generate": "generate-config",      # would otherwise make it ambiguous
}


def resolve_command(name: str) -> str:
    """Unambiguous-prefix command matching (``commandline.d:500-514``)."""
    if name in COMMANDS:
        return name
    if name in ALIASES and ALIASES[name] in COMMANDS:
        return ALIASES[name]
    matches = [c for c in COMMANDS if c.startswith(name)]
    if len(matches) == 1:
        return matches[0]
    if not matches:
        raise SystemExit(f"unknown command: {name!r} (see --commands)")
    raise SystemExit(f"ambiguous command {name!r}: matches {', '.join(sorted(matches))}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dentist-tpu",
        description="TPU-native genome assembly gap closer (capabilities of DENTIST)",
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("--commands", action="store_true", help="list sub-commands")
    p.add_argument("--config-schema", action="store_true",
                   help="print the JSON schema for --config files "
                        "(reference: generated config-schema.json)")
    sub = p.add_subparsers(dest="command")
    p.subparser_registry = {}

    def add(name, *specs, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("--config", help="YAML/JSON config file")
        sp.add_argument("-v", "--verbose", action="count", default=0,
                        help="increase output to help identify problems; "
                             "use up to three times")
        sp.add_argument("-q", "--quiet", action="store_true",
                        help="reduce output as much as possible, reporting "
                             "only fatal errors; overrides --verbose")
        sp.add_argument("--revert", action="append", metavar="<option>[,<option>...]",
                        help="revert named option to its default value; useful "
                             "to revert specific options of a config file")
        for spec in specs:
            flags, skw = spec
            sp.add_argument(*flags, **skw)
        p.subparser_registry[name] = sp
        return sp

    A = lambda *flags, **kw: (flags, kw)

    add("dust", A("sequences"), A("out_mask"))
    add("tandem", A("sequences"), A("out_mask"))
    add("align", A("assembly"), A("out_alignments"),
        A("--mask", nargs="*"), A("--max-alignment-error", type=float, default=0.3),
        A("--min-anchor-length", type=int, default=500))
    add("map", A("assembly"), A("reads"), A("out_alignments"), A("--mask", nargs="*"))
    add("mask-repetitive-regions", A("assembly"), A("alignments"), A("out_mask"),
        A("--reads-db"), A("--read-coverage", type=float),
        A("--max-coverage-reads", type=int), A("--max-coverage-self", type=int, default=4))
    add("propagate-mask", A("mask"), A("alignments"), A("reads"), A("out_mask"),
        A("--direction", choices=["assembly2reads", "reads2assembly"],
          default="assembly2reads",
          help="which way to transfer intervals through the alignments "
               "(reads2assembly is the homogenization return leg)"),
        A("--assembly", help="assembly FASTA/store (required with "
                             "--direction reads2assembly)"))
    add("merge-masks", A("out_mask"), A("masks", nargs="+"))
    add("filter-mask", A("mask"), A("out_mask"),
        A("--min-interval-size", type=int, default=0),
        A("--min-gap-size", type=int, default=0))
    add("show-mask", A("mask"), A("--json", "-j", action="store_true"))
    add("bed2mask", A("assembly"), A("bed"), A("out_mask"),
        A("--data-comments", action="store_true"))
    add("mask2bed", A("assembly"), A("mask"), A("out_bed"))
    add("chain-local-alignments", A("alignments"), A("out_alignments"),
        A("--progress", action="store_true",
          help="report progress while chaining"),
        A("--progress-every", type=int, default=500, metavar="MSECS",
          help="progress report interval (default: 500 ms)"),
        A("--progress-format", choices=["human", "json"], default="human"))
    add("collect-pile-ups", A("assembly"), A("reads"), A("alignments"), A("out_pile_ups"),
        A("--mask", nargs="*"), A("--min-anchor-length", type=int, default=500),
        A("--best-pile-up-margin", type=float, default=3.0),
        A("--existing-gap-bonus", type=float, default=6.0),
        A("--min-spanning-reads", type=int, default=3),
        A("--proper-alignment-allowance", type=int, default=126,
          help="consider chains proper if begin/end within <num> bp of "
               "the contig/read ends (default: trace spacing)"),
        A("--debug-pile-ups", help="dump pile-ups after each sub-stage to <stem>.<stage>.npz"))
    add("show-pile-ups", A("pile_ups"), A("--json", "-j", action="store_true"))
    add("process-pile-ups", A("assembly"), A("reads"), A("alignments"),
        A("pile_ups"), A("out_insertions"), A("--mask", nargs="*"),
        A("--batch", help="from..to slice of pile ups"),
        A("--min-reads-per-pile-up", type=int, default=3,
          help="skip pile ups with fewer than <num> reads "
               "(processPileUps/package.d:383)"),
        A("--allow-single-reads", action="store_true"))
    add("show-insertions", A("insertions"), A("--json", "-j", action="store_true"))
    add("merge-insertions", A("out_insertions"), A("partial_insertions", nargs="+"))
    add("output", A("assembly"), A("insertions"), A("out_assembly"),
        A("--agp"), A("--closed-gaps-bed"), A("--scaffolding"),
        A("--join-policy", default="scaffoldGaps",
          choices=["scaffoldGaps", "scaffolds", "contigs"]),
        A("--min-extension-length", type=int, default=100),
        A("--max-insertion-error", type=float, default=0.1),
        A("--fasta-line-width", type=int, default=50),
        A("--no-highlight-insertions", "-H", action="store_true"),
        A("--only", choices=["gaps", "extensions"]),
        A("--skip-gaps", nargs="*"), A("--skip-gaps-file"))
    add("translate-coords", A("scaffolding"), A("coords", nargs="+"),
        A("--json", "-j", action="store_true"))
    add("validate-regions", A("assembly"), A("reads"), A("alignments"), A("regions"),
        A("--read-coverage", type=float), A("--ploidy", type=int, default=1),
        A("--min-coverage-reads", type=int), A("--min-spanning-reads", type=int, default=3),
        A("--weak-coverage-mask"))
    add("export-las", A("alignments"), A("out_las"))
    add("import-las", A("las"), A("out_alignments"))
    add("export-mask", A("assembly"), A("mask"), A("out_anno"), A("out_data"))
    add("import-mask", A("anno"), A("data"), A("out_mask"))
    add("intrinsic-qv", A("alignments"), A("reads"), A("--out", default=None),
        A("--json", "-j", action="store_true"))
    add("lost-gaps", A("logs", nargs="+",
                       help="pipeline log file(s) or a --workdir directory"))
    add("fasta2db", A("fasta"), A("db"), A("--prolog", default="reads"))
    add("fasta2dam", A("fasta"), A("dam"))
    add("dbshow", A("db"), A("--width", type=int, default=50))
    add("generate-config", A("--read-coverage", type=float),
        A("--ploidy", type=int, default=1),
        A("--schema", action="store_true",
          help="print the config JSON schema instead of a config skeleton"),
        A("--preset", choices=["default", "greedy"], default="default",
          help="greedy: sensitivity-over-specificity preset "
               "(snakemake/dentist.greedy.yml)"))
    add("check-scaffolding", A("true_assembly"), A("test_assembly"),
        A("result_assembly"))
    add("validate-config", A("config_file"))
    add("simulate-reads", A("genome"), A("out_reads"),
        A("--coverage", type=float, default=20.0),
        A("--mean-length", type=int, default=25000),
        A("--sd-length", type=int, default=12500),
        A("--error", type=float, default=0.13),
        A("--seed", type=int, default=19339))
    add("build-partial-assembly", A("true_assembly"), A("out_assembly"),
        A("--num-gaps", type=int, default=3),
        A("--min-gap-size", type=int, default=50),
        A("--max-gap-size", type=int, default=500),
        A("--seed", type=int, default=7))
    add("find-closable-gaps", A("assembly"), A("reads"),
        A("--min-spanning-reads", type=int, default=3))
    add("check-results", A("true_assembly"), A("test_assembly"), A("result_assembly"),
        A("--json", "-j", action="store_true"),
        A("--bucket-size", type=int, default=500))
    add("pipeline", A("assembly"), A("reads"), A("out_assembly"),
        A("--read-coverage", type=float, default=None),
        A("--max-coverage-self", type=int, default=4),
        A("--min-spanning-reads", type=int, default=3),
        A("--min-anchor-length", type=int, default=500),
        A("--join-policy", default="scaffoldGaps",
          choices=["scaffoldGaps", "scaffolds", "contigs"]),
        A("--max-insertion-error", type=float, default=0.1),
        A("--no-validation", action="store_true"),
        A("--allow-single-reads", action="store_true"),
        A("--ploidy", type=int, default=1),
        A("--max-alignment-error", type=float, default=0.3),
        A("--best-pile-up-margin", type=float, default=3.0),
        A("--existing-gap-bonus", type=float, default=6.0),
        A("--min-reads-per-pile-up", type=int, default=None,
          help="default: follow --min-spanning-reads"),
        A("--proper-alignment-allowance", type=int, default=126),
        A("--no-resume", action="store_true",
          help="recompute even when --workdir holds stage artifacts"),
        A("--workdir", default=None))
    return p
