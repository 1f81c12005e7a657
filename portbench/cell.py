"""A cell of ``BENCHMARK.json`` and the files it names: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``) and
the readers of its per-layer metrics (``metrics/<metric>.py``). Every
one is found by its name, so a later cell, mix or metric is files and
entries, and no edit."""

from __future__ import annotations

import importlib.util
import json
import os

from portbench.reads import check_mix

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def load_reader(name: str, root: str = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    def __init__(self, name: str, repo: str, bench_root: str = HERE):
        bench = _load_json(os.path.join(repo, "BENCHMARK.json"))
        work = [w for w in bench["workloads"] if w["name"] == name]
        if not work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = work[0]
        self.name = name
        self.chips = int(w["chips"])
        conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
        self.config = _load_json(os.path.join(repo, conf["file"]))
        self.mix = _load_json(os.path.join(bench_root, "traffic",
                                           w["traffic"] + ".json"))
        check_mix(self.mix)
        self.limits = _load_json(os.path.join(bench_root, "limits",
                                              name + ".json"))
        self.end_to_end = bench["end_to_end"]
        self.per_layer = bench["per_layer"]
        self.readers = {m["name"]: load_reader(m["name"], bench_root)
                        for m in self.per_layer}
        g = self.config["guarantees"]
        if g["strand_arrangement"] != self.mix["orientation"]:
            raise ValueError(f"{name}: the mix's orientation is not the "
                             "configuration's strand arrangement")
        if self.config["cards"] != self.chips:
            raise ValueError(f"{name}: the configuration's cards are not "
                             "the cell's chips")
