"""Nothing the benchmark runs imports JAX or the JAX package, the references
import nothing of the program, and a run without a card prints no result."""

import ast
import os
import subprocess
import sys

from portbench.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "multilinear_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(spec.BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f): sorted(set(_imports(f)) & FORBIDDEN) for f in files}
    assert not {f: b for f, b in bad.items() if b}
    # the top-level name is compared whole: the port's name starts with the JAX package's
    assert "multilinear_tpu_torch" not in FORBIDDEN


def test_the_references_and_the_yardstick_import_nothing_of_the_program():
    for folder in ("reference", "core", "metrics"):
        for f in (spec.BENCH / folder).glob("*.py"):
            assert "multilinear_tpu_torch" not in set(_imports(f)), f


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(spec.BENCH / "run.py"), "--workload", "pcs.seg2p24", "--seed",
                          str(2**33 + 1), "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no card" in out.stderr


def test_the_harness_names_what_it_may_not_hold():
    from portbench.core.harness import FORBIDDEN as held

    assert set(held) == FORBIDDEN
