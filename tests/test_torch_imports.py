"""The port imports neither JAX nor the JAX package.

An AST scan of every module of soap3dp_tpu_torch (and of chip_smoke.py
and the compare scripts) finds no import of ``jax``, ``jaxlib``, any
``soap3dp_tpu`` module, the repo's ``tests`` and ``tools`` (which
drive the JAX package) or its ``bench`` (the JAX package's benchmark,
whose genomes and pairs the port's tools copy);
a subprocess builds an index with ``soap3dp-torch build``, runs the
port's CLI (pair on one device and on a two-replica mesh, so through
soap3dp_tpu_torch.distributed; single) and API end to end on the CPU,
and then finds neither ``jax`` nor any ``soap3dp_tpu`` module (other
than ``soap3dp_tpu_torch*``) in ``sys.modules``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "soap3dp_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "compare_e2e.py",
                                           "compare_dp.py",
                                           "compare_kernels.py",
                                           "compare_prescan.py",
                                           "compare_rescue.py",
                                           "compare_search.py",
                                           "compare_seed_forms.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    """(module, imported name or None) for every import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, None
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                yield node.module, a.name


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_module_imports_no_jax(path):
    for mod, name in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "soap3dp_tpu"), (path, mod, name)
        # the repo's top-level tools and bench.py drive the JAX package
        if root in ("tests", "tools", "bench") or mod == "__graft_entry__":
            raise AssertionError((path, mod))


@pytest.mark.parametrize("line", [
    "from tools import repeat_genome",
    "import tools.evaluate_accuracy",
    "from tools.measure_phased_divergence import run_ab",
    "from tests.conftest import make_genome",
    "import bench",
    "from bench import INSERT, make_pairs",
    "import bench.sub",
])
def test_scan_refuses_the_repo_scripts(tmp_path, line):
    """The scan fails on an import of the repo's tools, tests or
    bench.py."""
    path = tmp_path / "m.py"
    path.write_text(line + "\n")
    with pytest.raises(AssertionError):
        test_module_imports_no_jax(str(path))


def test_cli_run_leaves_jax_unimported(tmp_path):
    from soap3dp_tpu_torch.utils import dna

    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, 20_000).astype(np.uint8)
    (tmp_path / "g.fa").write_text(">c\n" + dna.decode(codes).decode() + "\n")
    with open(tmp_path / "r1.fq", "w") as f1, \
            open(tmp_path / "r2.fq", "w") as f2:
        for b, p in enumerate(rng.integers(0, 19_000, 8)):
            r1 = dna.decode(codes[p:p + 60]).decode()
            r2 = dna.decode(dna.revcomp_codes(codes[p + 140:p + 200])).decode()
            f1.write(f"@q{b}\n{r1}\n+\n{'I' * 60}\n")
            f2.write(f"@q{b}\n{r2}\n+\n{'I' * 60}\n")
    code = (
        "import sys\n"
        "from soap3dp_tpu_torch.cli.main import main\n"
        f"rc = main(['build', {str(tmp_path / 'g.fa')!r}])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['pair', {str(tmp_path / 'g.fa.index')!r}, "
        f"{str(tmp_path / 'r1.fq')!r}, {str(tmp_path / 'r2.fq')!r}, "
        f"'-o', {str(tmp_path / 'out')!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        f"rc = main(['pair', {str(tmp_path / 'g.fa.index')!r}, "
        f"{str(tmp_path / 'r1.fq')!r}, {str(tmp_path / 'r2.fq')!r}, "
        f"'-o', {str(tmp_path / 'mesh')!r}, '--device', 'cpu', "
        "'--devices', '2'])\n"
        "assert rc == 0, rc\n"
        "assert 'soap3dp_tpu_torch.distributed.mesh' in sys.modules\n"
        f"rc = main(['single', {str(tmp_path / 'g.fa.index')!r}, "
        f"{str(tmp_path / 'r1.fq')!r}, '-o', {str(tmp_path / 'se')!r}, "
        "'--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "from soap3dp_tpu_torch import api\n"
        f"idx = api.load({str(tmp_path / 'g.fa.index')!r}, device='cpu')\n"
        "assert len(api.align_single_r(idx, ['ACGTACGTACGTACGTACGTAC'])) == 1\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'soap3dp_tpu')]\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX" in res.stdout
    recs = [l for l in open(tmp_path / "out.sam") if not l.startswith("@")]
    assert len(recs) == 16


def test_tests_package_is_this_directory():
    """The tests import their helpers as ``tests.<module>``: ``tests``
    is this directory as a regular package, so an installed top-level
    ``tests`` package (some Python installations hold one) cannot shadow
    it, as such a package shadows a namespace package."""
    import tests

    assert tests.__file__ is not None
    assert os.path.dirname(os.path.abspath(tests.__file__)) == os.path.join(
        ROOT, "tests")
    from tests import conftest

    assert os.path.dirname(conftest.__file__) == os.path.join(ROOT, "tests")
