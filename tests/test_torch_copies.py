"""The port's copies of the JAX package's host modules are copies.

The port imports nothing of ``dentist_tpu``; it keeps its own copy of
each host module it needs, at the same relative path.  A copy may differ
from its origin only in its import lines (the origins import relatively,
so today the copies are byte-identical): any other difference would be a
fork, and a parity fault.  Citations of the DENTIST reference's sources
are compared relative to its checkout (a copy names
``source/dentist/...`` where its origin names the checkout's path).
The port's ``cli.py`` holds the JAX CLI's
sub-command names, prefix matching and argument definitions, which must
parse as the JAX package's do, and its handlers and their helpers, whose
source must equal the JAX package's, import lines aside.
"""

import ast
import inspect
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = [
    "utils/__init__.py", "utils/log.py", "utils/regions.py",
    "io/__init__.py", "io/fasta.py", "io/store.py", "io/dazzdb.py",
    "models/alignments.py", "models/scaffold.py", "models/insertions.py",
    "models/sequences.py", "models/output.py", "models/validate.py",
    "models/mask.py", "models/pileups.py", "ops/seeding.py", "ops/chain.py",
    "native.py", "sim/__init__.py", "sim/genome.py", "sim/partial.py",
    "sim/reads.py", "config.py", "eval/__init__.py", "eval/closable.py",
    "eval/check_results.py", "eval/check_scaffolding.py", "ops/qv.py",
    "io/dazzler.py",
]

_IMPORT = re.compile(r"^\s*(from\s+\S+\s+import\s|import\s)")
#: an absolute path to the DENTIST reference's checkout, up to its
#: sources: a copy may cite them relative to the checkout
_REF_CHECKOUT = re.compile(r"/\S*/source/dentist/")


def _without_imports(path: str) -> list:
    return _strip_imports(open(path).read().splitlines())


def _strip_imports(lines: list) -> list:
    out, in_import = [], False
    for line in lines:
        if in_import:  # the continuation lines of a parenthesized import
            in_import = not line.rstrip().endswith(")")
            continue
        if _IMPORT.match(line):
            in_import = line.rstrip().endswith("(")
            continue
        out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_in_imports(rel):
    origin = os.path.join(ROOT, "dentist_tpu", rel)
    copy = os.path.join(ROOT, "dentist_tpu_torch", rel)
    got, want = ([_REF_CHECKOUT.sub("source/dentist/", line)
                  for line in _without_imports(path)]
                 for path in (copy, origin))
    assert got == want, rel


def _actions(parser):
    return sorted((tuple(a.option_strings), a.dest, repr(a.default),
                   getattr(a.type, "__name__", None), repr(a.choices),
                   repr(a.nargs), repr(a.const))
                  for a in parser._actions)


def test_cli_parser_equals_jax():
    from dentist_tpu import cli as jax_cli
    from dentist_tpu_torch import cli as port_cli

    assert list(port_cli.COMMANDS) == list(jax_cli.COMMANDS)
    assert port_cli.ALIASES == jax_cli.ALIASES
    pj, pp = jax_cli.build_parser(), port_cli.build_parser()
    assert _actions(pp) == _actions(pj)
    assert sorted(pp.subparser_registry) == sorted(pj.subparser_registry)
    for name, sp in pj.subparser_registry.items():
        assert _actions(pp.subparser_registry[name]) == _actions(sp), name


def test_cli_prefix_matching_equals_jax():
    from dentist_tpu import cli as jax_cli
    from dentist_tpu_torch import cli as port_cli

    prefixes = {name[:k] for name in jax_cli.COMMANDS
                for k in range(1, len(name) + 1)} | set(jax_cli.ALIASES)
    for prefix in sorted(prefixes):
        try:
            want = jax_cli.resolve_command(prefix)
        except SystemExit as exc:
            with pytest.raises(SystemExit, match=re.escape(str(exc))):
                port_cli.resolve_command(prefix)
        else:
            assert port_cli.resolve_command(prefix) == want, prefix


def _cli_functions() -> list:
    """The JAX CLI's handlers (``cmd_*``) and the helpers they call: every
    top-level function of ``dentist_tpu/cli.py`` but its parser, prefix
    matching and ``main``."""
    tree = ast.parse(open(os.path.join(ROOT, "dentist_tpu", "cli.py")).read())
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name not in ("command", "resolve_command", "build_parser",
                               "main")]


@pytest.mark.parametrize("name", _cli_functions())
def test_cli_handler_equals_jax(name):
    from dentist_tpu import cli as jax_cli
    from dentist_tpu_torch import cli as port_cli

    want = inspect.getsource(getattr(jax_cli, name)).splitlines()
    got = inspect.getsource(getattr(port_cli, name)).splitlines()
    assert _strip_imports(got) == _strip_imports(want), name
    registered = {fn.__name__: c for c, fn in jax_cli.COMMANDS.items()}
    if name in registered:  # a handler, under the same sub-command
        assert port_cli.COMMANDS[registered[name]].__name__ == name
