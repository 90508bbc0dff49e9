"""Configuration file system.

Mirrors the reference's config semantics
(``source/dentist/common/configfile.d``):

- YAML or JSON file with a ``__default__`` section applied to every
  command plus per-command sections keyed by CLI command name
  (``configDefaultKey``, ``configfile.d:72-82``);
- comment keys starting with ``//`` are ignored;
- CLI arguments win over config values (config is merged "retroactively"
  into defaults — ``retroInitFromConfig``, ``configfile.d:117``);
- positional arguments given as ``-`` on the CLI take their value from
  the config file (``configEmptyArgument``, ``configfile.d:76``);
- a ``revert`` key in a command section (or ``--revert`` on the CLI)
  resets the named options to their built-in defaults *after* the config
  merge — used to cancel config values for one command
  (``commandline.d:2415-2435``; ``Snakefile:1372`` reverts validation
  options for the preliminary output);
- file size capped at 256 MiB (``configfile.d``);
- dashed keys (``max-coverage-self``) map to python option names
  (``max_coverage_self``);
- a JSON schema equivalent to the reference's generated
  ``config-schema.json`` is derived from the argparse command registry
  (:func:`config_schema`) and used by ``validate-config``.
"""

from __future__ import annotations

import argparse
import json
import os

__all__ = [
    "load_config", "command_options", "ConfigError", "CONFIG_DEFAULT_KEY",
    "CONFIG_EMPTY_ARGUMENT", "config_schema", "apply_config", "validate_config",
]

CONFIG_DEFAULT_KEY = "__default__"
CONFIG_EMPTY_ARGUMENT = "-"
MAX_CONFIG_SIZE = 256 * 1024 * 1024

#: option dests that are CLI plumbing, not config-settable stage options
_NON_CONFIG_DESTS = {"config", "help", "revert"}


class ConfigError(Exception):
    pass


def load_config(path: str) -> dict:
    if os.path.getsize(path) > MAX_CONFIG_SIZE:
        raise ConfigError(f"config file exceeds {MAX_CONFIG_SIZE} bytes")
    with open(path) as fh:
        text = fh.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        try:
            data = yaml.safe_load(text)
        except yaml.YAMLError as exc:
            raise ConfigError(f"config is neither valid JSON nor YAML: {exc}")
    if not isinstance(data, dict):
        raise ConfigError("config root must be a mapping")
    return _strip_comments(data)


def _strip_comments(obj):
    if isinstance(obj, dict):
        return {k: _strip_comments(v) for k, v in obj.items() if not str(k).startswith("//")}
    if isinstance(obj, list):
        return [_strip_comments(v) for v in obj]
    return obj


def command_options(config: dict, command: str) -> dict:
    """Merged option dict for `command`: defaults then command section."""
    merged: dict = {}
    for section in (config.get(CONFIG_DEFAULT_KEY, {}), config.get(command, {})):
        if not isinstance(section, dict):
            raise ConfigError(f"config section for {command!r} must be a mapping")
        for k, v in section.items():
            merged[str(k).replace("-", "_")] = v
    return merged


def apply_config(args, config: dict, command: str, explicit: set[str],
                 positional_dests: set[str] = frozenset()) -> None:
    """Set config values on an argparse namespace unless given on the CLI.

    `explicit` holds destination names the user set explicitly; config
    never overrides those (CLI wins — reference ``retroInitFromConfig``).
    Positional arguments (``positional_dests``) are only taken from the
    config when their CLI value is the ``-`` sentinel
    (``configfile.d:76``, applied ``configfile.d:135-147``).
    """
    for key, value in command_options(config, command).items():
        if key == "revert" or not hasattr(args, key):
            continue
        if key in positional_dests:
            current = getattr(args, key)
            if isinstance(current, list):
                if all(v == CONFIG_EMPTY_ARGUMENT for v in current):
                    setattr(args, key, value if isinstance(value, list) else [value])
            elif current == CONFIG_EMPTY_ARGUMENT:
                setattr(args, key, value)
            continue
        if key in explicit:
            continue
        setattr(args, key, value)


def revert_options(args, names, defaults: dict) -> None:
    """Reset the named options to their built-in defaults.

    Mirrors ``--revert`` (``commandline.d:2415-2435``); accepts dashed
    option names, comma-joined strings, or lists thereof. Unknown names
    raise :class:`ConfigError` like the reference's CLIException.
    """
    flat: list[str] = []
    for name in ([names] if isinstance(names, str) else list(names or [])):
        flat.extend(str(name).split(","))
    for name in flat:
        dest = name.strip().lstrip("-").replace("-", "_")
        if not dest:
            continue
        if dest not in defaults or not hasattr(args, dest):
            raise ConfigError(f"invalid value for --revert: unknown option --{name}")
        setattr(args, dest, defaults[dest])


# ----------------------------------------------------------------------
# JSON schema generation (reference: generated ``config-schema.json``)


def _action_schema(action: argparse.Action) -> dict | None:
    if action.dest in _NON_CONFIG_DESTS or action.dest == argparse.SUPPRESS:
        return None
    if isinstance(action, (argparse._HelpAction, argparse._VersionAction)):
        return None
    if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
        item: dict = {"type": "boolean"}
    elif isinstance(action, argparse._CountAction):
        item = {"type": "integer"}
    elif action.type is int:
        item = {"type": "integer"}
    elif action.type is float:
        item = {"type": "number"}
    else:
        item = {"type": "string"}
    if action.choices:
        item["enum"] = list(action.choices)
    if action.nargs in ("*", "+") or (isinstance(action.nargs, int) and action.nargs > 1):
        item = {"type": "array", "items": item}
    if action.help:
        item["description"] = " ".join(str(action.help).split())
    return item


def _config_name(action: argparse.Action) -> str:
    for opt in action.option_strings:
        if opt.startswith("--"):
            return opt[2:]
    if action.option_strings:
        return action.option_strings[0].lstrip("-")
    return action.dest.replace("_", "-")


def config_schema(subparsers: dict[str, argparse.ArgumentParser]) -> dict:
    """Build the config JSON schema from the command registry.

    The shape mirrors the reference's ``config-schema.json`` (top-level
    ``properties`` keyed by command name plus ``__default__`` holding the
    union of every command's options; ``jsonschema.d``).
    """
    command_props: dict[str, dict] = {}
    default_props: dict[str, dict] = {}
    for name, sp in sorted(subparsers.items()):
        props: dict[str, dict] = {}
        for action in sp._actions:
            item = _action_schema(action)
            if item is None:
                continue
            props[_config_name(action)] = item
        props["revert"] = {
            "type": "array", "items": {"type": "string"},
            "description": "revert named options to their default values "
                           "after the config merge",
        }
        command_props[name] = {"type": "object", "properties": props,
                               "additionalProperties": False}
        for key, item in props.items():
            if key != "revert":
                default_props.setdefault(key, item)
    command_props[CONFIG_DEFAULT_KEY] = {
        "type": "object", "properties": default_props,
        "additionalProperties": False,
    }
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "$id": "https://github.com/dentist-tpu/config-schema.json",
        "title": "DENTIST-TPU configuration",
        "description": "YAML/JSON configuration: a __default__ section applied "
                       "to every command plus per-command sections.",
        "type": "object",
        "properties": command_props,
    }


_SCHEMA_TYPE_CHECKS = {
    "boolean": lambda v: isinstance(v, bool),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "string": lambda v: isinstance(v, str),
}


def _check_value(name: str, value, item: dict, errors: list[str], where: str):
    typ = item.get("type", "string")
    if typ == "array":
        if not isinstance(value, list):
            errors.append(f"{where}: {name!r} must be an array")
            return
        for v in value:
            _check_value(name, v, item.get("items", {}), errors, where)
        return
    if not _SCHEMA_TYPE_CHECKS.get(typ, lambda v: True)(value):
        errors.append(f"{where}: {name!r} must be of type {typ}")
    if "enum" in item and value not in item["enum"]:
        errors.append(f"{where}: {name!r} must be one of {item['enum']}")


def validate_config(config: dict, known_commands: list[str],
                    schema: dict | None = None) -> list[str]:
    """Semantic checks; returns a list of error strings (empty = valid).

    With `schema` (from :func:`config_schema`), every key is checked to be
    a valid option of its section and every value to match the option's
    type — the reference validates configs against its generated JSON
    schema (``validateConfig``, ``configfile.d:246-273``).
    """
    errors = []
    for key in config:
        if key != CONFIG_DEFAULT_KEY and key not in known_commands:
            errors.append(f"unknown config section: {key!r}")
    default = config.get(CONFIG_DEFAULT_KEY, {})
    if not isinstance(default, dict):
        errors.append("__default__ must be a mapping")
    elif "revert" in default:
        # Snakefile:403-406 semantic check
        errors.append("highly discouraged use of `revert` in `__default__`")
    if schema is not None:
        props = schema.get("properties", {})
        for section_name, section in config.items():
            section_schema = props.get(section_name)
            if section_schema is None or not isinstance(section, dict):
                continue
            allowed = section_schema.get("properties", {})
            for key, value in section.items():
                item = allowed.get(str(key))
                if item is None:
                    errors.append(
                        f"{section_name}: unknown option {key!r}")
                    continue
                if key == "revert" and isinstance(value, str):
                    continue  # comma-joined string form is accepted
                _check_value(str(key), value, item, errors, section_name)
    # mutually exclusive options (validate_dentist_config.py semantics)
    for section_name, section in config.items():
        if not isinstance(section, dict):
            continue
        if "read_coverage" in _norm(section) and "max_coverage_reads" in _norm(section):
            errors.append(
                f"{section_name}: must not provide both read-coverage and max-coverage-reads"
            )
    return errors


def _norm(section: dict) -> set[str]:
    return {str(k).replace("-", "_") for k in section}
