"""The benchmark loads neither JAX nor the JAX package, and no module of
its references (`reference/*.py`, `common` with the families) loads
anything of the program: each checked in a fresh interpreter, by the
top-level name of every loaded module compared whole."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
JAX_PACKAGE = "pytorch_end2end_speech_recognition_tpu"
PORT = JAX_PACKAGE + "_torch"

HARNESS_RUN = """
import json, sys, torch
from portbench import calibrate, harness, judge, run, trace, traffic
from portbench.tests import small
for kind in ("metrics", "counts"):
    for p in sorted((harness.ROOT / kind).glob("*.py")):
        harness.load_module(kind, p.stem)
r = harness.run("conformer_m.serve.30s", 7, 0.2, False,
                torch.device("cpu"), small.bench(),
                files=(small.config_doc(), small.SERVE_MIX,
                       small.limits("conformer_m.serve.30s")))
assert r["correct"], r
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE_ONLY = """
import importlib, json, sys
importlib.import_module("portbench.reference.{}")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCES = sorted(p.stem for p in (REPO / "portbench" / "reference")
                    .glob("*.py") if p.stem != "__init__")


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _top_level_modules(HARNESS_RUN)
    assert PORT in tops  # the run drove the program
    for name in ("jax", "jaxlib", "flax", JAX_PACKAGE):
        assert name not in tops


@pytest.mark.parametrize("module", REFERENCES)
def test_reference_loads_nothing_of_the_program(module):
    tops = _top_level_modules(REFERENCE_ONLY.format(module))
    for name in ("jax", "jaxlib", "flax", JAX_PACKAGE, PORT):
        assert name not in tops
