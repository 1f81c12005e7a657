"""BENCHMARK.json and the files it names: every configuration, mix,
limit and metric reader found by its name; a mix added as a new file
runs through the general generator with no file edited.

    python -m pytest portbench -q
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import pytest

from portbench import cell as cell_mod
from portbench import genome, reads
from portbench.reference.judge import NUMBERS

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_cell_loads_its_files():
    b = bench()
    for w in b["workloads"]:
        c = cell_mod.Cell(w["name"], ROOT)
        assert set(c.limits) == set(NUMBERS)
        assert c.readers and all(callable(r) for r in c.readers.values())
        assert any(m["name"] == "setup_s" for m in c.end_to_end)


def test_names_units_and_moves():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] == "reads_per_s"
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200


def test_a_mix_added_as_a_file_runs(tmp_path):
    """A later PR's mix: a new file in a copy of traffic/, found by name
    and run through the generator; nothing that exists is edited."""
    root = tmp_path / "bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(".cache"))
    mix = dict(json.load(open(root / "traffic" / "wgs.json")),
               sub_rate=0.02, indel_reads=0.1)
    (root / "traffic" / "long-indels.json").write_text(json.dumps(mix))
    b = bench()
    b["workloads"].append({"name": "chr1-pe100.long-indels",
                           "config": "chr1-pe100", "traffic": "long-indels",
                           "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "limits" / "chr1-pe100.long-indels.json").write_text(
        (root / "limits" / "chr1-pe100.wgs.json").read_text())
    shutil.copytree(os.path.join(HERE, "configs"),
                    tmp_path / "portbench" / "configs")
    c = cell_mod.Cell("chr1-pe100.long-indels", str(tmp_path), str(root))
    g = genome.generate(8_000_000, 20240817, log=lambda m: None)
    r = reads.simulate(g, c.mix, 2000, np.random.default_rng(3))
    assert int(r.indel.sum()) == round(0.1 * 4000)


def test_a_metric_reader_is_found_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "my.new_metric.py").write_text(
        "def read(run):\n    return run['window_reads'] / 2\n")
    read = cell_mod.load_reader("my.new_metric", str(tmp_path))
    assert read({"window_reads": 10}) == 5


def test_a_mix_against_the_configuration_is_refused(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(".cache"))
    mix = dict(json.load(open(root / "traffic" / "wgs.json")),
               orientation="-/+")
    (root / "traffic" / "mate-pairs.json").write_text(json.dumps(mix))
    b = bench()
    b["workloads"][0]["traffic"] = "mate-pairs"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copytree(os.path.join(HERE, "configs"),
                    tmp_path / "portbench" / "configs")
    with pytest.raises(ValueError, match="orientation"):
        cell_mod.Cell(b["workloads"][0]["name"], str(tmp_path), str(root))
