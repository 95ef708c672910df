"""Structured logger for the launchers (``repro_torch.obs.log``, a copy of ``repro.obs.log``).

One module-level logger replaces the scattered ``print()`` calls in
``launch/serve.py`` / ``launch/train.py`` / ``launch/dryrun.py``:

  * **default** — ``info(msg)`` prints ``msg`` verbatim, so human
    output is byte-identical to the old prints;
  * ``--json``  — each call emits one JSON object per line
    (``{"msg": ..., **fields}``) for machine consumption;
  * ``--quiet`` — informational output is suppressed entirely.

Launchers wire it up with two calls::

    from repro_torch.obs import log
    log.add_flags(ap)          # adds --quiet / --json
    args = ap.parse_args()
    log.configure(args)
    log.info(f"resumed from step {step}", step=step)

The keyword fields are only serialized in ``--json`` mode; in human
mode the pre-formatted ``msg`` is the output, which is what keeps the
default byte-identical.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Optional

_state: Dict[str, bool] = {"json": False, "quiet": False}


def add_flags(parser: argparse.ArgumentParser) -> None:
    """Register ``--quiet`` / ``--json`` on a launcher's parser."""
    parser.add_argument("--quiet", action="store_true",
                        help="suppress informational log output")
    parser.add_argument("--json", dest="json_logs", action="store_true",
                        help="emit one JSON object per log line")


def configure(args: Optional[argparse.Namespace] = None, *,
              json_logs: bool = False, quiet: bool = False) -> None:
    if args is not None:
        json_logs = bool(getattr(args, "json_logs", False))
        quiet = bool(getattr(args, "quiet", False))
    _state["json"] = json_logs
    _state["quiet"] = quiet


def info(msg: str = "", **fields: Any) -> None:
    """Log one line; ``msg`` is printed verbatim in human mode."""
    if _state["quiet"]:
        return
    if _state["json"]:
        print(json.dumps({"msg": msg, **fields}, sort_keys=True,
                         default=str), flush=True)
    else:
        print(msg, flush=True)
