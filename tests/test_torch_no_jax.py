"""The port runs without jax, PyYAML and svo_tpu.

A fresh interpreter with those three blocked in sys.modules imports every
module of svo_tpu_torch (the kernel wrappers, the batched engine, the
back-end, the checkpoint module, the probe, the tracker timing script,
the readers, the three entry points, the reference CPU pipeline, the soak,
worlds, recovery, refinement-sweep, fleet and EuRoC harnesses, the
distributed modules, the soak's reference drift, the timing and
profiling tools, the scaling harness with its two workers and its
trace, and the captured chunk dispatch among them;
cv2 only when
the reference pipeline is built) and chip_smoke.py,
runs detect_fast and detect_orb on the CPU, constructs
BatchedStereoVO there and builds its refiner; the EuRoC reader must ask
for PyYAML only when it reads a sensor file, and each entry point must
parse its arguments with the card as the default device (soak_ref, the
host-only OpenCV pipeline, has no --device);
chip_smoke.main(), probe.main() and track_times.main() must refuse to run
without a CUDA device, with a non-zero code and nothing on stdout.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = r"""
import os, sys
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
        "svo_tpu_torch.track_times", "svo_tpu_torch.ba.solver",
        "svo_tpu_torch.ba.window", "svo_tpu_torch.ba.pose_graph",
        "svo_tpu_torch.parallel.global_opt", "svo_tpu_torch.utils.checkpoint",
        "svo_tpu_torch.ops.harris", "svo_tpu_torch.io.kitti", "svo_tpu_torch.io.euroc",
        "svo_tpu_torch.utils.metrics", "svo_tpu_torch.viz.dump", "svo_tpu_torch.runtime.loader",
        "svo_tpu_torch.run_synthetic", "svo_tpu_torch.run_kitti",
        "svo_tpu_torch.run_euroc", "svo_tpu_torch.eval.reference_cpu",
        "svo_tpu_torch.soak", "svo_tpu_torch.eval_worlds", "svo_tpu_torch.parallel.ba",
        "svo_tpu_torch.parallel.multihost", "svo_tpu_torch.parallel.multi_seq",
        "svo_tpu_torch.parallel.collective", "svo_tpu_torch.multihost_ba_worker",
        "svo_tpu_torch.eval_recovery", "svo_tpu_torch.eval_ba", "svo_tpu_torch.eval_fleet",
        "svo_tpu_torch.eval_euroc", "svo_tpu_torch.soak_ref", "svo_tpu_torch.bench_batched",
        "svo_tpu_torch.time_chunk", "svo_tpu_torch.profile_chunk", "svo_tpu_torch.klt_bench",
        "svo_tpu_torch.microbench", "svo_tpu_torch._staging", "svo_tpu_torch.scaling_eff",
        "svo_tpu_torch.scaling_worker", "svo_tpu_torch.frontend_scaling_worker",
        "svo_tpu_torch.scaling_trace", "svo_tpu_torch.pipeline.graph"} <= set(mods)
assert "cv2" not in sys.modules  # the reference pipeline imports it when built
assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
from svo_tpu_torch.config import Config
from svo_tpu_torch.io.synthetic import SyntheticSequence
from svo_tpu_torch.ops.detect import detect_fast, detect_orb
img = SyntheticSequence(n_frames=1, shape=(96, 256), fx=120.0, seed=3).frame(0)[0]
pos, score, valid = detect_fast(torch.from_numpy(img), 20.0, None,
                                Config(use_orb=False, image_height=96, image_width=256))
assert pos.shape == (192, 2) and int(valid.sum()) > 10
pos, score, valid = detect_orb(torch.from_numpy(img), None, Config(image_height=96, image_width=256))
assert pos.shape == (192, 2) and int(valid.sum()) > 10
from svo_tpu_torch.io.euroc import EurocSequence
try:  # the sensor files need PyYAML, which is blocked here
    EurocSequence(os.path.join(@REPO@, "tests", "fixtures", "euroc_mini"))
    raise AssertionError("yaml was imported")
except ImportError:
    pass
from svo_tpu_torch import probe, track_times
from svo_tpu_torch.geometry.camera import from_intrinsics
from svo_tpu_torch.parallel.batched import BatchedStereoVO
bvo = BatchedStereoVO(Config(use_orb=False, image_height=96, image_width=256),
                      from_intrinsics(120.0, 120.0, 128.0, 48.0, 0.5), 2, device="cpu")
assert (bvo.chunk, bvo.kf_cadence) == (12, 6)
assert callable(bvo.make_refiner())
import chip_smoke
assert not torch.cuda.is_available()
from svo_tpu_torch import (bench_batched, eval_ba, eval_euroc, eval_fleet, eval_recovery,
                           eval_worlds, frontend_scaling_worker, klt_bench, microbench,
                           multihost_ba_worker, profile_chunk, run_euroc, run_kitti, run_synthetic,
                           scaling_eff, scaling_trace, scaling_worker, soak, soak_ref,
                           time_chunk)
worker = ["--rank", "0", "--nprocs", "2", "--port", "1", "--out", "x"]
for cli, argv in ((run_synthetic, []), (run_kitti, []), (run_euroc, ["--root", "x"]), (soak, []),
                  (eval_worlds, []), (multihost_ba_worker, ["--rank", "0", "--port", "1", "--out", "x"]),
                  (eval_recovery, []), (eval_ba, []), (eval_fleet, []), (eval_euroc, []),
                  (bench_batched, []), (time_chunk, []), (profile_chunk, []), (klt_bench, []),
                  (microbench, []), (scaling_eff, []), (scaling_trace, []),
                  (scaling_worker, worker),
                  (frontend_scaling_worker, worker)):
    assert cli.parse_args(argv).device == "cuda"  # the card unless asked
assert not hasattr(soak_ref.parse_args([]), "device")
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
    assert int(lines[-1].split()[1]) >= 45
