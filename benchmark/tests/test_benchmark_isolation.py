"""What a run loads: no module whose top-level name is JAX's or the JAX
package's, and, for the reference, nothing of the program. Top-level names
are compared whole: `seedvr2_tpu_torch` begins with `seedvr2_tpu`."""

import json
import subprocess
import sys

from benchmark import harness

REPO = harness.HERE.parent


def _top_level_after(imports: str):
    code = (f"import sys\n{imports}\n"
            "print(__import__('json').dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level_after(
        "import benchmark.run, benchmark.harness, benchmark.control\n"
        "import seedvr2_tpu_torch.cli, seedvr2_tpu_torch.core.loader\n"
        "import seedvr2_tpu_torch.models.vae.pipeline_vae")
    assert "seedvr2_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_after(
        "import benchmark.reference.pipeline, benchmark.reference.dit\n"
        "import benchmark.reference.vae, benchmark.reference.color\n"
        "import benchmark.weights, benchmark.compare")
    assert not names & (set(harness.FORBIDDEN) | {"seedvr2_tpu_torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "seedvr2_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "seedvr2_tpu.probe", sys)
    found = harness.forbidden_modules()
    assert "seedvr2_tpu.probe" in found
    assert "seedvr2_tpu_torch_probe" not in found
