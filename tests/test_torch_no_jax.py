"""The port runs without jax, PyYAML and svo_tpu.

A fresh interpreter with those three blocked in sys.modules imports every
module of svo_tpu_torch (the kernel wrappers, the batched engine, the probe
and the tracker timing script among them) and chip_smoke.py, runs
detect_fast on the CPU and constructs BatchedStereoVO there;
chip_smoke.main(), probe.main() and track_times.main() must refuse to run
without a CUDA device, with a non-zero code and nothing on stdout.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = r"""
import sys
for name in ("jax", "yaml", "svo_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
sys.path.insert(0, @REPO@)
import importlib, pkgutil
import numpy as np, torch
import svo_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(svo_tpu_torch.__path__, "svo_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"svo_tpu_torch.ops.klt_patches", "svo_tpu_torch.ops.lk_fused",
        "svo_tpu_torch.parallel.batched", "svo_tpu_torch.probe",
        "svo_tpu_torch.track_times"} <= set(mods)
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
from svo_tpu_torch.config import Config
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.ops.detect import detect_fast
img = SyntheticSequence(n_frames=1, shape=(96, 256), fx=120.0, seed=3).frame(0)[0]
pos, score, valid = detect_fast(torch.from_numpy(img), 20.0, None,
                                Config(use_orb=False, image_height=96, image_width=256))
assert pos.shape == (192, 2) and int(valid.sum()) > 10
from svo_tpu_torch import probe, track_times
from svo_tpu_torch.geometry.camera import from_intrinsics
from svo_tpu_torch.parallel.batched import BatchedStereoVO
bvo = BatchedStereoVO(Config(use_orb=False, image_height=96, image_width=256),
                      from_intrinsics(120.0, 120.0, 128.0, 48.0, 0.5), 2, device="cpu")
assert (bvo.chunk, bvo.kf_cadence) == (12, 6)
import chip_smoke
assert not torch.cuda.is_available()
assert chip_smoke.main() == 1
assert probe.main() == 1
assert track_times.main() == 1
print("IMPORTED", len(mods))
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _DRIVER.replace("@REPO@", repr(REPO))],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines == [lines[-1]] and lines[-1].startswith("IMPORTED")
    assert int(lines[-1].split()[1]) >= 20
