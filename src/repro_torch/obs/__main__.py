"""CLI entry: ``python -m repro_torch.obs analyze TRACE [--json] [...]``
and ``python -m repro_torch.obs regress [--baselines DIR] [--run DIR]
[...]``."""
import sys


def _dispatch(argv):
    # ``regress`` has its own flat parser; everything else goes through
    # the analyze subcommand parser.
    if argv and argv[0] == "regress":
        from .regress import main as regress_main
        return regress_main(argv[1:])
    from .analyze import main as analyze_main
    return analyze_main(argv)


if __name__ == "__main__":
    sys.exit(_dispatch(sys.argv[1:]))
