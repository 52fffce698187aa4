#!/usr/bin/env python
"""Generate ``docs/cli_torch.md`` from the argparse trees of the PyTorch
port's launchers (``repro_torch.launch.{simulate,serve,train,dryrun}``).

    PYTHONPATH=src python scripts/gen_cli_docs_torch.py            # rewrite
    PYTHONPATH=src python scripts/gen_cli_docs_torch.py --check    # drift gate

The page is fully derived: each flag table comes from the launcher's
``build_parser()`` (its help strings are the single source of truth) and
the worked examples live in this generator.  ``--check`` exits 1 when
the committed page differs from what the parsers give now.  The port's
counterpart of ``scripts/gen_cli_docs.py``.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, os.path.join(ROOT, "src"))

DOC_PATH = os.path.join(ROOT, "docs", "cli_torch.md")
LAUNCHERS = ("simulate", "serve", "train", "dryrun")

PROLOG = """\
# `repro_torch.launch` — command-line reference of the PyTorch port

> **Generated file — do not edit.**  Regenerate with
> `PYTHONPATH=src python scripts/gen_cli_docs_torch.py` (`--check` fails
> on drift).

Four launchers, each the counterpart of the JAX package's launcher of
the same name (`docs/cli.md`).  Every one but the dry run runs on the
GPU unless `--device cpu` is given, and fails without a GPU rather than
falling back to the CPU.

```sh
# the simulator: solo, serial, sweep, plan and zoo modes
PYTHONPATH=src python -m repro_torch.launch.simulate --rows 4 --cols 4 \\
    --refs 12 --device cpu
PYTHONPATH=src python -m repro_torch.launch.simulate --zoo patterns-tiny \\
    --device cpu

# continuous-batching LM serving, any registry id
PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
    --reduced --device cpu

# LM training with checkpoints (--mesh single|multi under torchrun)
PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
    --reduced --steps 12 --batch 2 --seq 32 --device cpu

# rank 0 of a production mesh on a fake process group (no device)
PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
    --shape train_4k --mesh multi
```

## Workload sources

`--app`, `--apps`, the APP field of `--plan` manifests and the zoo
families name a traffic generator of `repro_torch.core.workloads`:

```text
%SOURCE_HELP%
```
"""


def flag_table(ap: argparse.ArgumentParser) -> str:
    rows = ["| flag | type | default | description |",
            "|---|---|---|---|"]
    for a in ap._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        flag = ", ".join(f"`{s}`" for s in a.option_strings) or f"`{a.dest}`"
        if a.choices:
            typ = "{" + ",".join(str(c) for c in a.choices) + "}"
        elif isinstance(a, argparse._StoreTrueAction):
            typ = "flag"
        elif a.type in (int, float):
            typ = a.type.__name__
        else:
            typ = "str"
        default = ("" if a.default is None or a.default is False
                   or a.default is argparse.SUPPRESS
                   else f"`{a.default}`")
        help_text = " ".join((a.help or "").split())
        rows.append(f"| {flag} | {typ} | {default} | {help_text} |")
    return "\n".join(rows) + "\n"


def render() -> str:
    from repro_torch.core.workloads import source_help
    parts = [PROLOG.replace("%SOURCE_HELP%", source_help())]
    for name in LAUNCHERS:
        ap = importlib.import_module(
            f"repro_torch.launch.{name}").build_parser()
        parts.append(f"\n## `{ap.prog}`\n\n"
                     f"{' '.join((ap.description or '').split())}\n\n"
                     + flag_table(ap))
    return "".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) if docs/cli_torch.md differs from "
                         "the argparse trees instead of rewriting it")
    args = ap.parse_args(argv)
    text = render()
    if args.check:
        try:
            with open(DOC_PATH) as f:
                on_disk = f.read()
        except FileNotFoundError:
            print(f"gen_cli_docs_torch: {DOC_PATH} missing", file=sys.stderr)
            return 1
        if on_disk != text:
            print("gen_cli_docs_torch: docs/cli_torch.md drifted from the "
                  "argparse trees; run: PYTHONPATH=src python "
                  "scripts/gen_cli_docs_torch.py", file=sys.stderr)
            return 1
        print("gen_cli_docs_torch: docs/cli_torch.md is current")
        return 0
    with open(DOC_PATH, "w") as f:
        f.write(text)
    print(f"gen_cli_docs_torch: wrote {DOC_PATH}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
