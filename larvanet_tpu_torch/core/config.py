"""Cascaded flag parsing helpers (larvanet_tpu/core/config.py:52-75).

Each stage (CLI -> model) consumes its own flags with `parse_known_args`
and hands the rest on, as the reference's CLIs do.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Sequence, Tuple


def parse_known(parser: argparse.ArgumentParser,
                args: Sequence[str]) -> Tuple[argparse.Namespace, List[str]]:
    """Plugin-side `parse_args(args) -> (namespace, remaining)`."""
    ns, remaining = parser.parse_known_args(args=list(args))
    return ns, remaining


def dump_arguments_json(path: str, *namespaces: argparse.Namespace) -> None:
    """Write the merged run config, like reference train.py:75-78."""
    merged: Dict[str, Any] = {}
    for ns in namespaces:
        if ns is not None:
            merged.update(vars(ns))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(merged, sort_keys=True, indent=2, default=str))


def parse_scale_list(scales: str) -> List[int]:
    """'2,3,4' -> [2, 3, 4]."""
    return [int(x) for x in scales.split(",")]
