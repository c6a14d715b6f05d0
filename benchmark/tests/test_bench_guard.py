"""No JAX and no module of the JAX package in a run; the reference imports
nothing of the measured program."""

import subprocess
import sys
from pathlib import Path

from benchmark import guard

ROOT = Path(__file__).resolve().parents[2]


def test_names_are_compared_whole():
    assert guard.loaded_forbidden(["this_and_that_vdm_tpu_torch.ops", "torch"]) == []
    assert guard.loaded_forbidden(["this_and_that_vdm_tpu.models"]) == ["this_and_that_vdm_tpu"]
    assert guard.loaded_forbidden(["jax.numpy", "jaxlib.xla", "flax"]) == ["flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports() == []


def test_reference_import_is_caught(tmp_path):
    (tmp_path / "bad.py").write_text("from this_and_that_vdm_tpu_torch import ops\n")
    assert guard.reference_imports(tmp_path) == [("bad.py", 1)]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, guard\n"
            "for k in ('closed_loop_serve', 'train_steps'):\n"
            "    harness.load_module(harness.HERE / 'generators' / (k + '.py'))\n"
            "import this_and_that_vdm_tpu_torch.serving.server, "
            "this_and_that_vdm_tpu_torch.weights.loader, "
            "this_and_that_vdm_tpu_torch.training.train_loop\n"
            "print(guard.loaded_forbidden())\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
