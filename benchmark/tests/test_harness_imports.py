"""Nothing the harness runs loads JAX or the JAX package: a fresh interpreter runs each cell's set-up path
(the program built from the seed, the engine warmed up or the first align step taken) at the tiny size on
the CPU, then lists the loaded modules whose top-level name is ``jax``, ``jaxlib``, ``flax`` or
``merv_tpu``, compared whole, since ``merv_tpu_torch`` begins with ``merv_tpu``. And a run that finds no
card prints no result and fails."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

SETUP = {
    "serve": """
from benchmark.drivers import serve_closed as d
c = tiny.cell("serve")
b = d.build(c)
d.warm_up(b, c)
""",
    "train": """
from benchmark.drivers import train_align as d
c = tiny.cell("train")
vidlm, strategy = d.build(c)
d.first_steps(strategy, d.make_batches(c, vidlm.llm_backbone.pad_token_id), 1)
""",
}


def run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("kind", sorted(SETUP))
def test_a_cells_set_up_loads_neither_jax_nor_the_jax_package(kind):
    code = ("import json, sys\nfrom benchmark import run\nfrom benchmark.tests import tiny\n" + SETUP[kind] +
            "print(json.dumps(run.forbidden_modules()))\n"
            "print(sorted(m for m in sys.modules if m.startswith('merv_tpu')))")
    proc = run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-2]) == []
    assert "merv_tpu_torch" in lines[-1]  # the port was loaded, under its own name


def test_forbidden_names_are_compared_whole():
    proc = run("import sys, types\nfrom benchmark import run\n"
               "sys.modules['merv_tpu_torch_x'] = types.ModuleType('merv_tpu_torch_x')\n"
               "sys.modules['jaxtyping'] = types.ModuleType('jaxtyping')\n"
               "print(run.forbidden_modules())\n"
               "sys.modules['merv_tpu.conf'] = types.ModuleType('merv_tpu.conf')\n"
               "print(run.forbidden_modules())")
    assert proc.stdout.split("\n")[:2] == ["[]", "['merv_tpu']"], proc.stdout + proc.stderr


def test_a_run_without_a_card_prints_nothing_and_fails():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "qwen7b.describe", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout.strip() == ""
