"""The plain reference (vobench/reference) against the port's eager path
(graph=False) on the CPU at 96x320, where both run the same plain
PyTorch: every pose and map point bit-equal, for the batched cadenced
chunk with a refine sweep (kitti00-fast's settings, the fused engine's
plain version) and for one stream frame by frame with ORB and the window
BA (kitti00-orb-ba's, the patches engine). And the imports: vobench with
jax and svo_tpu blocked by whole top-level name, the reference with
svo_tpu_torch blocked too."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from conftest import ROOT, SMALL_CAMERA, SMALL_SHAPE

from vobench import frames, spec


def _configs(name):
    from svo_tpu_torch.config import Config as PortConfig
    from vobench.reference.config import Config as RefConfig

    cfg = json.load(open(os.path.join(ROOT, "vobench", "configs", f"{name}.json")))
    cfg["pipeline"].update(image_height=SMALL_SHAPE[0], image_width=SMALL_SHAPE[1])
    cam = dict(cfg["camera"], **SMALL_CAMERA)
    return (spec.with_overrides(PortConfig(), cfg["pipeline"]),
            spec.with_overrides(RefConfig(), cfg["pipeline"]),
            (cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["baseline"]))


def _seq(n):
    K = np.array([[SMALL_CAMERA["fx"], 0, SMALL_CAMERA["cx"]],
                  [0, SMALL_CAMERA["fy"], SMALL_CAMERA["cy"]], [0, 0, 1.0]])
    return frames.make_sequence(11, n, SMALL_SHAPE, K, 0.5372, "cpu")


def _equal(a, b):
    from svo_tpu_torch.pipeline.state import leaves

    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


def test_batched_chunks_and_sweep_match_the_port():
    from svo_tpu_torch.geometry.camera import from_intrinsics
    from svo_tpu_torch.parallel.batched import BatchedStereoVO
    from vobench.reference.drive import Reference

    port_cfg, ref_cfg, cam = _configs("kitti00-fast")
    seq = _seq(25)
    S, K = 2, 12
    bvo = BatchedStereoVO(port_cfg, from_intrinsics(*cam), S, chunk=K, kf_cadence=6,
                          device="cpu", lk_engine="fused", graph=False)
    ref = Reference(ref_cfg, cam, "cpu", "fused", chunk=K, cadence=6)
    l0 = torch.stack([seq.left[0], seq.left[-1]])
    r0 = torch.stack([seq.right[0], seq.right[-1]])
    bvo.start(l0, r0, seed=2**31 + 3)
    state = ref.bootstrap(l0, r0, [2**31 + 3, 2**31 + 4])
    for c in range(2):
        idx = torch.arange(1 + c * K, 1 + (c + 1) * K)
        lefts = torch.stack([seq.left[idx], seq.left[24 - idx]], dim=1)
        rights = torch.stack([seq.right[idx], seq.right[24 - idx]], dim=1)
        bvo.process_chunk(lefts, rights)
        state = ref.chunk(state, lefts, rights)
    bvo.refine()
    state = ref.refine(state)
    _equal(bvo.state, state)


def test_frame_by_frame_orb_with_window_ba_matches_the_port():
    from svo_tpu_torch.config import BaParams
    from svo_tpu_torch.geometry.camera import from_intrinsics
    from svo_tpu_torch.pipeline.odometry import StereoVO
    from vobench.reference.config import BaParams as RefBaParams
    from vobench.reference.drive import Reference
    import dataclasses

    port_cfg, ref_cfg, cam = _configs("kitti00-orb-ba")
    # a window BA that runs inside 24 frames: window 3, every 2nd keyframe
    port_cfg = dataclasses.replace(port_cfg, ba=BaParams(enabled=True, window=3, interval=2))
    ref_cfg = dataclasses.replace(ref_cfg, ba=RefBaParams(enabled=True, window=3, interval=2))
    seq = _seq(25)
    vo = StereoVO(port_cfg, from_intrinsics(*cam), seed=9, device="cpu", graph=False)
    ref = Reference(ref_cfg, cam, "cpu", vo.lk_engine)
    vo.start(seq.left[0].numpy(), seq.right[0].numpy())
    state = ref.bootstrap(seq.left[0], seq.right[0], 9)
    for f in range(1, 25):
        vo.process(seq.left[f].numpy(), seq.right[f].numpy())
    state = ref.frames(state, seq.left[1:], seq.right[1:])
    assert int(vo.state.kf_flags.sum()) >= 4  # the BA ran, at the 4th keyframe at least
    _equal(vo.state, state)


BLOCKER = """
import importlib.abc, sys
BLOCKED = set(sys.argv[1].split(","))
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
"""


def _run_blocked(blocked: str, code: str):
    out = subprocess.run([sys.executable, "-c", BLOCKER + code, blocked], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_vobench_runs_with_jax_and_svo_tpu_blocked():
    code = """
import sys
sys.path.insert(0, "vobench/tests")
import vobench, vobench.run, vobench.harness, vobench.calibrate
from conftest import small_cell
from vobench import harness
r = harness.run(small_cell("kitti00-fast.fleet8"), 3, 0.5, True, "cpu")
assert r["attempted"] > 0
assert not harness.forbidden_loaded()
print("ok")
"""
    assert _run_blocked("jax,jaxlib,flax,svo_tpu", code).strip().endswith("ok")


def test_reference_imports_nothing_of_the_port():
    code = """
import vobench.reference.drive, vobench.check
print("ok")
"""
    assert _run_blocked("jax,jaxlib,flax,svo_tpu,svo_tpu_torch", code).strip() == "ok"
