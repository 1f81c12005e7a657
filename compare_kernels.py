"""Compare the device times of the port's DP kernels and FS3 between
checkouts of the repo on one CUDA card, in the order given.

    python3 compare_kernels.py TREE [TREE ...]

For example PARENT CHANGE CHANGE PARENT, each a checkout whose K1, K2
and TB take their outputs as the result wire's (kernels/banded_dp.py
run_budget and on). The DP problems are made once,
by this checkout's chip_smoke.py with phase 2's helpers and seeds: K1 at
phase 2's path_P8192 case (8192 x 120 x 256, reads of 100), K2 and TB at
its mate_window case (2048 x 120 x 4224) on K2's directions. Each run is
a fresh process in one checkout (compare_e2e.run_in_tree) that builds
its kernels, loads those problems and times each kernel by
torch.profiler's device events (chip_smoke._kernel_device_ms) and by
CUDA events around a loop of calls (the wrapper's host work included),
REPS calls each; FS3 at round 1's largest call of a 65,536-pair batch on
phase 4's 250 Mbp index (built once and shared by the runs). Each run
also holds K1's, TB's and FS3's outputs against their plain versions.
Prints one line per run and writes them to compare_kernels.json in
chip_smoke.py's output directory.
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from compare_e2e import ROOT, run_in_tree

REPS = 20  # calls a timing (K2, a call of milliseconds: REPS // 4)

RUN = """
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.index.builder import load_index
from soap3dp_tpu_torch.kernels import banded_dp as bd

reps = {reps}
out = {{}}
d = np.load({inputs!r})


def t(key):
    return [torch.from_numpy(d[f"{{key}}_{{i}}"]).to(dev) for i in range(9)]


args = t("k1")
k1_ms = cs._k1_ms(bd, args, reps)
out["K1_ms"], out["K1_call_ms"] = k1_ms[0], k1_ms[1]
out["K1_equal"] = cs._dp_equal(bd.dp_align(*args),
                               bd.dp_align_plain(*args))[0]
del args

args = t("tb")
fwd = bd.dp_forward(*args[:8])
P, Lr = args[0].shape
mr = bd.run_budget(Lr, args[2].shape[1])
params = bd._packed(*args)[2]
st = torch.empty((P, 8), dtype=torch.int32, device=dev)
k2 = lambda: bd._launch_forward(args[0], args[2], params, fwd[4], st,
                                bd.DPScores())
out["K2_ms"] = cs._kernel_device_ms(k2, reps // 4, "dp_forward_kernel")
runs = torch.empty((P, mr), dtype=torch.int32, device=dev)
tb = lambda: bd._launch_traceback(fwd[4], params, st, runs, mr)
out["TB_ms"] = cs._kernel_device_ms(tb, reps, "dp_traceback_kernel")
out["TB_call_ms"] = cs._events_ms(tb, reps)
act = fwd[0] >= args[8]
tb_args = (args[1], fwd[1], fwd[2], args[4], act.cpu().numpy())
got = bd.dp_traceback(fwd[4], args[0], args[1], args[2], *tb_args[1:])
want = bd._dp_traceback_plain(fwd[4], *tb_args)
out["TB_equal"] = all(np.shape(a) == np.shape(b) and np.array_equal(a, b)
                      for a, b in zip(got, want))
del fwd, args
torch.cuda.empty_cache()

_, genome, path, _, _, _ = cs._genome_index(250_000_000, {work!r})
didx = fmindex.device_index(load_index(path), dev)
calls = [a for fn, a in cs.path_calls(didx, genome.codes, 65536)
         if fn == "count_mismatches_rows"]
a = max(calls, key=lambda a: a[1].shape[0])
out["FS3_placements"] = int(a[1].shape[0])
f = lambda: fmindex.count_mismatches_rows(*a)
out["FS3_ms"] = cs._kernel_device_ms(f, reps, "verify_kernel")
out["FS3_call_ms"] = cs._events_ms(f, reps)
out["FS3_equal"] = bool(torch.equal(f().cpu(),
                                    fmindex.count_mismatches_rows_plain(*a)
                                    .cpu()))
print("RESULT " + json.dumps(out), flush=True)
"""


def write_inputs(path: str) -> None:
    """Phase 2's K1 path_P8192 and wide mate_window problems, as the
    arrays k1_0 .. k1_8 and tb_0 .. tb_8 of an .npz at ``path``."""
    k1 = dict(cs.k1_cases(np.random.default_rng(cs.K1_SEED)))["path_P8192"]
    name, tb, _ = cs.wide_cases(np.random.default_rng(cs.WIDE_SEED))[0]
    assert name == "mate_window"
    np.savez(path, **{f"k1_{i}": np.ascontiguousarray(x)
                      for i, x in enumerate(k1)},
             **{f"tb_{i}": np.ascontiguousarray(x) for i, x in enumerate(tb)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    work = os.path.join(ROOT, "soap3dp_tpu_torch", "_build", "e2e")
    os.makedirs(work, exist_ok=True)
    inputs = os.path.join(work, "compare_kernels_problems.npz")
    write_inputs(inputs)
    card = cs.card_line()
    print(card, flush=True)
    runs = []
    for tree in args.trees:
        runs.append({"tree": tree, **run_in_tree(
            tree, RUN, work=work, inputs=inputs, reps=REPS)})
        print(json.dumps(runs[-1]), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "compare_kernels.json"), "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)
    bad = [r["tree"] for r in runs
           if not (r["K1_equal"] and r["TB_equal"] and r["FS3_equal"])]
    if bad:
        sys.exit(f"a kernel disagrees with its plain version in {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
