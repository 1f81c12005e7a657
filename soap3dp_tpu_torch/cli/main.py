"""soap3dp-torch: the aligner CLI of the PyTorch / CUDA port.

  soap3dp-torch single <index> <reads> [options] [--device cuda]
  soap3dp-torch pair <index> <reads1> <reads2> [options] [--device cuda]
  soap3dp-torch single-multi <index> <list-file> [options] [--device cuda]
  soap3dp-torch pair-multi <index> <list-file> [options] [--device cuda]

The same commands and flags as ``soap3dp`` (soap3dp_tpu/cli/main.py,
whose option parsing this reuses), plus ``--device``: ``cuda`` (the
default; an error when no CUDA device exists), ``cuda:K`` or ``cpu``.
``--devices N`` replicates the index over N devices and shards every
batch over them (on CUDA min(N, cards) cards from --device's on, 0 =
all; on the CPU N replicas). ``--hosts N --host-id I --coordinator
host:port`` runs process I of N, which aligns every Nth batch into
``<prefix>.I`` outputs; a --hosts above 1 without a host id or a
coordinator (flags or SOAP3DP_HOST_ID / SOAP3DP_COORDINATOR) exits 2.
"""

from __future__ import annotations

import argparse
import sys
import time

COMMANDS = ("single", "pair", "single-multi", "pair-multi")


def parse_args(argv: list[str]):
    """(command, parsed arguments) of a command line whose first word is
    one of COMMANDS."""
    from soap3dp_tpu.cli.main import _add_common

    cmd = argv[0]
    sub = argparse.ArgumentParser(prog=f"soap3dp-torch {cmd}", add_help=False)
    sub.add_argument("index")
    if cmd == "single":
        sub.add_argument("reads")
    elif cmd == "pair":
        sub.add_argument("reads1")
        sub.add_argument("reads2", nargs="?", default=None)
        sub.add_argument("-u", type=int, default=500, dest="max_insert")
        sub.add_argument("-v", type=int, default=1, dest="min_insert")
    else:
        sub.add_argument("listfile")
    sub.add_argument("--device", default="cuda", dest="torch_device",
                     help="torch device: cuda (default), cuda:K or cpu")
    _add_common(sub)
    return cmd, sub.parse_args(argv[1:])


def main(argv=None) -> int:
    from soap3dp_tpu_torch.cli.runner import (close_hosts, host_config,
                                              run_multi, run_pair, run_single)

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__, file=sys.stderr)
        return 0 if argv and argv[0] in ("--help", "-help") else 2
    cmd, args = parse_args(argv)
    try:
        host_config(args)
    except ValueError as e:
        print(f"[soap3dp] error: {e}", file=sys.stderr)
        return 2

    t0 = time.time()
    try:
        if cmd == "single":
            rc = run_single(args)
        elif cmd == "pair":
            rc = run_pair(args)
        else:
            rc = run_multi(cmd, args)
    except (FileNotFoundError, IsADirectoryError, PermissionError) as e:
        print(f"[soap3dp] error: {e.strerror or e}: "
              f"{e.filename or ''}".rstrip(": "), file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"[soap3dp] error: {e}", file=sys.stderr)
        return 1
    finally:
        close_hosts()
    print(f"[soap3dp] total wall time: {time.time() - t0:.2f}s",
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
