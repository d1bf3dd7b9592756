"""The PyTorch port stands alone: importing it, or the on-card smoke script,
pulls in neither jax nor the JAX package, and builds no kernel."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "multilinear_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
import multilinear_tpu_torch as pkg
names = ["multilinear_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, "multilinear_tpu_torch.")
]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "multilinear_tpu"))
from multilinear_tpu_torch import _build
print("MODULES", len(names))
print("NAMES", ",".join(names))
print("BAD", bad)
print("BUILT", _build._fns is not None or _build.build_seconds is not None)
"""


def _run_probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    return dict(line.split(" ", 1) for line in res.stdout.strip().splitlines())


@pytest.fixture(scope="module")
def probe():
    return _run_probe()


def test_import_leaves_no_jax_in_sys_modules(probe):
    assert int(probe["MODULES"]) >= 17
    assert "multilinear_tpu_torch.batched_pcs" in probe["NAMES"]
    assert "multilinear_tpu_torch.batched_fri" in probe["NAMES"]
    assert "multilinear_tpu_torch.device_transcript" in probe["NAMES"]
    assert "multilinear_tpu_torch.system" in probe["NAMES"]
    assert "multilinear_tpu_torch.sumcheck" in probe["NAMES"]
    assert "multilinear_tpu_torch.checkpoint" in probe["NAMES"]
    assert probe["BAD"] == "[]"


def test_the_package_names_every_module(probe):
    """``__all__`` lists every public module of the package."""
    import multilinear_tpu_torch

    public = {n.split(".")[1] for n in probe["NAMES"].split(",")
              if n.count(".") >= 1 and not n.split(".")[1].startswith("_")}
    assert set(multilinear_tpu_torch.__all__) == public


def test_import_triggers_no_build(probe):
    assert probe["BUILT"] == "False"
    assert not os.path.isdir(os.path.join(PKG, "build")) or not any(
        f.endswith(".tmp") for f in os.listdir(os.path.join(PKG, "build"))
    )


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|multilinear_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 15
    offenders = [f for f in files if pat.search(open(f).read())]
    assert offenders == []


def test_every_kernel_source_and_binding_is_present():
    from multilinear_tpu_torch import _build

    for stem in _build.SOURCES:
        assert os.path.isfile(os.path.join(_build.CSRC, stem + ".cu")), stem
    assert {
        "mul", "addsub", "sha256_words", "sha256_leaves", "merkle_levels", "butterfly", "butterfly2",
        "twiddle_mul3", "kron", "zm", "fold", "fold_commit", "round_scalars", "open_gather",
        "sumcheck_round",
        # the probe kernels whose instructions the smoke script counts
        "opcount",
    } == set(_build.SOURCES)
    for symbol in ("mlt_sha256_messages", "mlt_sha256_leaves", "mlt_merkle_levels", "mlt_zm_tiles",
                   "mlt_kron_tiles", "mlt_round_scalars", "mlt_sumcheck_round_scalars", "mlt_open_gather",
                   "mlt_sumcheck_sums", "mlt_sumcheck_fold", "mlt_sumcheck_max_slots"):
        assert symbol in _build.KERNELS, symbol


def test_every_wrapper_names_a_bound_c_function():
    """Each ``mlt_*`` name a wrapper asks the loader for is in the binding
    table, and each bound function is defined by its source (the smoke
    script's own wrapper of the tensor product's parts included)."""
    from multilinear_tpu_torch import _build

    used = set()
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py") and f != "_build.py"]
    for path in files:
        text = open(path).read()
        used |= set(re.findall(r'"(mlt_\w+)"', text))
        # names built as "mlt_" + kernel from the launch-count keys
        if '"mlt_" + kernel' in text:
            used |= {"mlt_mul", "mlt_add", "mlt_sub"}
    assert used == set(_build.KERNELS), (used, set(_build.KERNELS))
    for symbol, (stem, _) in _build.KERNELS.items():
        src = open(os.path.join(_build.CSRC, stem + ".cu")).read()
        assert re.search(r'extern "C" int %s\(' % symbol, src), symbol


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path cannot be shown")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_wrappers_raise_for_a_tensor_on_an_unknown_device():
    """A wrapper takes its plain version only for a CPU tensor."""
    import torch

    from multilinear_tpu_torch import sha256_cuda
    from multilinear_tpu_torch.field import cuda_ops

    meta = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_ops.mul(meta, meta)
    with pytest.raises(ValueError):
        sha256_cuda.sha256_words(torch.zeros((4, 8), dtype=torch.int32, device="meta"))
