"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "nomad_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_and_not_the_jax_package():
    names = loaded_after(
        "import glob, os\n"
        "from nomadbench import harness, run, sweep, control, devtrace\n"
        "from nomadbench.drivers import waves, open_service, roll, inplace\n"
        "import nomad_tpu_torch.server.cluster\n"
        "for p in glob.glob('nomadbench/metrics/[!_]*.py'):\n"
        "    harness.load_reader(os.path.basename(p)[:-3])\n")
    assert "nomad_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_after("import nomadbench.reference, nomadbench.yardstick")
    assert "nomad_tpu_torch" not in names
    assert not names & FORBIDDEN
