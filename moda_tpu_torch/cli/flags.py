"""CLI flag parsing -> MoDAConfig: the port's copy of moda_tpu/cli/flags.py.

Accepts the reference's flag spellings (main.py / moda.py:42-177 absl
flags), including the --noflag negation form, so the template.sh recipes
translate without edits.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Sequence

from moda_tpu_torch.config import MoDAConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("moda_tpu_torch", allow_abbrev=False)
    for f in dataclasses.fields(MoDAConfig):
        name = f.name
        if f.type in ("bool", bool):
            p.add_argument(f"--{name}", dest=name, action="store_true", default=None)
            p.add_argument(f"--no{name}", dest=name, action="store_false", default=None)
        elif f.type in ("int", int):
            p.add_argument(f"--{name}", type=int, default=None)
        elif f.type in ("float", float):
            p.add_argument(f"--{name}", type=float, default=None)
        else:
            p.add_argument(f"--{name}", type=str, default=None)
    p.add_argument("--flagfile", type=str, default=None,
                   help="JSON config dump (opts.json) to load first")
    return p


def parse_config(argv: Sequence[str] | None = None) -> MoDAConfig:
    p = build_parser()
    args, unknown = p.parse_known_args(argv)
    if unknown:
        print(f"warning: ignoring unknown flags {unknown}")
    cfg = MoDAConfig()
    if args.flagfile:
        with open(args.flagfile) as f:
            cfg = MoDAConfig.from_json(f.read())
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k != "flagfile"}
    return cfg.replace(**overrides)
