"""soap3dp-torch: the aligner CLI of the PyTorch / CUDA port.

  soap3dp-torch single <index> <reads> [options] [--device cuda]
  soap3dp-torch pair <index> <reads1> <reads2> [options] [--device cuda]
  soap3dp-torch single-multi <index> <list-file> [options] [--device cuda]
  soap3dp-torch pair-multi <index> <list-file> [options] [--device cuda]
  soap3dp-torch build <fasta> [--sa-rate N] [--lut-k K] [--ini F]
  soap3dp-torch view <file.gout>

The same commands and flags as ``soap3dp`` (soap3dp_tpu/cli/main.py),
plus ``--device``: ``cuda`` (the default; an error when no CUDA device
exists), ``cuda:K`` or ``cpu``. ``build`` writes the index of a FASTA
file to ``<fasta>.index.t3i`` (cli/builder.py); ``view`` decodes
succinct output to text (cli/view.py).
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


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("-L", type=int, default=120, dest="max_read_len",
                    help="length of the longest read (default 120)")
    ap.add_argument("-h", type=int, default=2, dest="output_mode",
                    choices=[1, 2, 3, 4],
                    help="1 all valid; 2 all best (default); 3 unique best; "
                         "4 random best")
    ap.add_argument("-b", type=int, default=2, dest="output_format",
                    choices=[1, 2, 3], help="1 succinct; 2 SAM (default); 3 BAM")
    ap.add_argument("-o", dest="output_prefix", default=None,
                    help="output prefix (default: first read file)")
    ap.add_argument("-c", dest="device", default=None,
                    help="accepted for compatibility; the device is --device")
    ap.add_argument("--devices", type=int, default=1, dest="devices",
                    help="number of devices to use (0 = all). The index is "
                         "replicated per device and read batches are "
                         "sharded over them, the analog of the reference's "
                         "one-process-per-GPU ShareIndex recipe (README "
                         "section 3)")
    ap.add_argument("--hosts", type=int, default=None, dest="hosts",
                    help="multi-host mode: total number of aligner "
                         "processes (torch.distributed over gloo). Each "
                         "process takes every Nth input batch and writes "
                         "<prefix>.<host-id> outputs, merged like the "
                         "reference's per-process .gout.N files "
                         "(README section 3). Env fallbacks: "
                         "SOAP3DP_NUM_HOSTS/SOAP3DP_HOST_ID/"
                         "SOAP3DP_COORDINATOR")
    ap.add_argument("--host-id", type=int, default=None, dest="host_id",
                    help="this process's id in [0, hosts)")
    ap.add_argument("--coordinator", default=None, dest="coordinator",
                    help="the process group's address host:port")
    ap.add_argument("-I", action="store_true", dest="illumina13",
                    help="Illumina 1.3+ quality encoding")
    ap.add_argument("-A", dest="sample_name", default="default")
    ap.add_argument("-D", dest="read_group", default=None)
    ap.add_argument("-R", dest="rg_option", default="")
    ap.add_argument("-p", action="store_true", dest="output_md",
                    help="output MD string and NM tag")
    ap.add_argument("-s", type=int, nargs="?", const=-1, default=None,
                    dest="mismatch_only",
                    help="mismatch-only mode (disables DP); optional max "
                         "mismatches 0-4")
    ap.add_argument("--batch-size", type=int, default=None, dest="batch_size",
                    help="reads per device batch (default 65536)")
    ap.add_argument("--ini", default=None, help="ini file (default: "
                    "soap3-dp.ini next to the executable if present)")


def _build_options(args, first_read_file: str):
    from soap3dp_tpu_torch.cli.ini import load_ini_options
    from soap3dp_tpu_torch.pipeline.options import AlignOptions

    opts = load_ini_options(args.ini) or AlignOptions()
    opts.output_mode = args.output_mode
    opts.output_format = args.output_format
    opts.max_read_len = args.max_read_len
    opts.output_md = args.output_md
    opts.illumina13 = args.illumina13
    opts.sample_name = args.sample_name
    opts.read_group = args.read_group or first_read_file
    opts.rg_option = args.rg_option
    opts.output_prefix = args.output_prefix or first_read_file
    if getattr(args, "batch_size", None) is not None:
        opts.batch_size = args.batch_size
    if getattr(args, "min_insert", None) is not None:
        opts.min_insert = args.min_insert
    if getattr(args, "max_insert", None) is not None:
        opts.max_insert = args.max_insert
    if args.mismatch_only is not None:
        if args.mismatch_only == -1:
            opts.max_mismatches = 3 if args.max_read_len >= 50 else 2
        else:
            opts.max_mismatches = args.mismatch_only
    return opts


def parse_args(argv: list[str]):
    """(command, parsed arguments) of a command line whose first word is
    one of COMMANDS."""
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
    if argv and argv[0] == "build":
        from soap3dp_tpu_torch.cli import builder
        return builder.main(argv[1:])
    if argv and argv[0] == "view":
        from soap3dp_tpu_torch.cli import view
        return view.main(argv[1:])
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
