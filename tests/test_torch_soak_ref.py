"""The soak's reference drift, svo_tpu_torch/soak_ref.py, against svo_tpu's
scripts/soak_ref.py on the same 13 frames, on the CPU.

The port's main(["--frames", "13", "--out", F]) and svo_tpu's script run
as a subprocess with the same arguments both run the OpenCV reference
pipeline over the soak's sequence (376x1241, speed 0.3, seed 7); the two
JSON results are equal in every key but fps (the processing time),
exactly: the port's reference pipeline is a copy of svo_tpu's
(tests/test_torch_reference_cpu.py) and both feed float32 frames. svo_tpu's
script feeds uint8 frames instead when it finds a complete frame cache
(scripts/render_cache.py) for these arguments; the test skips then.
"""

import json
import os
import subprocess
import sys

import jax  # noqa: F401  (before torch and cv2)
import pytest
import torch

from svo_tpu_torch import soak_ref

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/render_cache.py's cache_dir(13, (376, 1241), 718.856, 0.3, 7)
CACHE_META = "/tmp/svo_cache/f13_376x1241_fx718.856_sp0.3_s7/meta.json"


def test_soak_ref_equals_svo_tpus_script(tmp_path):
    if os.path.exists(CACHE_META):
        pytest.skip(f"{CACHE_META} exists: svo_tpu's script would feed its uint8 frames")
    port, ref = tmp_path / "port.json", tmp_path / "svo_tpu.json"
    assert soak_ref.main(["--frames", "13", "--out", str(port)]) == 0
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "soak_ref.py"), "--frames", "13",
         "--out", str(ref)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    got, want = json.loads(port.read_text()), json.loads(ref.read_text())
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "fps"} == \
        {k: v for k, v in want.items() if k != "fps"}
    assert got["frames"] == 13 and got["finite"] and got["fps"] > 0
