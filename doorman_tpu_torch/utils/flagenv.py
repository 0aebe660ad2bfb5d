"""Populate argparse defaults from environment variables.

Port of doorman_tpu/utils/flagenv.py (reference
go/flagenv/flagenv.go:22-69): a flag `--foo-bar` with prefix DOORMAN falls
back to env var DOORMAN_FOO_BAR when not given on the command line.
"""

from __future__ import annotations

import argparse
import os


def flag_to_env(prefix: str, flag_name: str) -> str:
    return f"{prefix}_{flag_name}".upper().replace("-", "_")


def populate(parser: argparse.ArgumentParser, prefix: str = "DOORMAN") -> None:
    """For every parser option, use the matching env var as the default (an
    explicit command-line value still wins)."""
    for action in parser._actions:  # noqa: SLF001 - argparse has no public iterator
        if not action.option_strings:
            continue
        name = action.option_strings[-1].lstrip("-")
        env = flag_to_env(prefix, name)
        if env in os.environ:
            raw = os.environ[env]
            if action.type is not None:
                raw = action.type(raw)
            elif isinstance(action, argparse._StoreTrueAction):  # noqa: SLF001
                raw = raw.lower() in ("1", "true", "yes")
            elif isinstance(action, argparse._StoreFalseAction):  # noqa: SLF001
                # DOORMAN_NO_FOO=true means "apply the flag": dest = False.
                raw = raw.lower() not in ("1", "true", "yes")
            elif not isinstance(action, argparse._StoreAction):  # noqa: SLF001
                raise ValueError(
                    f"cannot populate {env}: unsupported action for "
                    f"--{name}"
                )
            action.default = raw
            action.required = False
