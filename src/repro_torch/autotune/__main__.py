"""CLI for the port's autotune subsystem.

    python -m repro_torch.autotune sweep [--kernels a,b] [--device-types x,y]
                                         [--tiny] [--merge-into DB]
                                         [--device cpu]
                                         --emit-costdb PATH
    python -m repro_torch.autotune show PATH
    python -m repro_torch.autotune merge A B [...] -o OUT
    python -m repro_torch.autotune validate PATH

``sweep`` runs on the GPU (the card measured, the other types
estimated) unless ``--device cpu`` asks for estimates only.
"""
from __future__ import annotations

import argparse
import sys

from .costdb import CostDB
from .measured import CARD_PEAKS, MeasuredCostModel, card_fractions
from .sweep import run_sweep


def _card_table(db: CostDB) -> str:
    """The cards' measured fractions of their own peaks."""
    rows = []
    for name in db.device_types():
        if name in CARD_PEAKS:
            for key, v in sorted(card_fractions(db, name).items()):
                rows.append(f"{name:9s} {key:19s} {v:8.3f}  (of the card's "
                            "peak)")
    return "\n".join(rows)


def _print_db(db: CostDB) -> None:
    print(db.describe())
    print()
    print(MeasuredCostModel(db).efficiency_table())
    cards = _card_table(db)
    if cards:
        print(cards)


def _sweep(args) -> int:
    base = CostDB.load(args.merge_into) if args.merge_into else None
    db = run_sweep(
        kernels=args.kernels.split(",") if args.kernels else None,
        device_types=(args.device_types.split(",")
                      if args.device_types else None),
        tiny=args.tiny, base=base, device=args.device)
    if args.emit_costdb:
        db.save(args.emit_costdb)
        print(f"wrote {args.emit_costdb}")
    _print_db(db)
    return 0


def _show(args) -> int:
    _print_db(CostDB.load(args.path))
    return 0


def _merge(args) -> int:
    db = CostDB()
    for p in args.paths:
        db.merge(CostDB.load(p))
    db.save(args.out)
    print(f"wrote {args.out} ({len(args.paths)} inputs)")
    return 0


def _validate(args) -> int:
    db = CostDB.load(args.path)          # raises on schema/version problems
    n = sum(len(b) for k in db.entries.values() for b in k.values())
    if n == 0:
        print(f"{args.path}: valid but EMPTY", file=sys.stderr)
        return 1
    print(f"{args.path}: schema v{db.schema_version} OK, {n} records over "
          f"{db.device_types()}")
    return 0


def main() -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.autotune",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="run the kernel sweep")
    sw.add_argument("--kernels", default="",
                    help="comma list (default: all four)")
    sw.add_argument("--device-types", default="",
                    help="comma list: the local card's type and "
                         "DeviceProfile names (default: the card's, "
                         "H800, H20)")
    sw.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' estimates "
                         "every type)")
    sw.add_argument("--tiny", action="store_true",
                    help="CI mode: one shape/kernel, ≤8 configs")
    sw.add_argument("--merge-into", default="",
                    help="existing CostDB to merge results over")
    sw.add_argument("--emit-costdb", required=True,
                    help="output path for the CostDB JSON (a sweep's "
                         "results are worthless unpersisted)")
    sw.set_defaults(fn=_sweep)

    sh = sub.add_parser("show", help="print a CostDB + derived factors")
    sh.add_argument("path")
    sh.set_defaults(fn=_show)

    mg = sub.add_parser("merge", help="merge CostDBs (best record wins)")
    mg.add_argument("paths", nargs="+")
    mg.add_argument("-o", "--out", required=True)
    mg.set_defaults(fn=_merge)

    va = sub.add_parser("validate", help="schema-check a CostDB")
    va.add_argument("path")
    va.set_defaults(fn=_validate)

    args = ap.parse_args()
    sys.exit(args.fn(args))


if __name__ == "__main__":
    main()
