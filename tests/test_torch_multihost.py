"""Two gloo processes on localhost, each holding 4 of 8 shards, run the
port's distributed BA through svo_tpu_torch/multihost_ba_worker.py (the
counterpart of scripts/multihost_ba_worker.py; it imports only the port):
the Schur-reduced camera system crosses the process boundary every LM
iteration. Both ranks must report ok (their shards bit-equal to the
one-process 8-shard solve each computes on a group of itself, and within
tests/test_dist_ba.py's bounds of the single solve), and their cameras,
points and costs must equal, bit for bit, the one-process 8-shard solve of
the same problem in this process.
"""

import json

import numpy as np
import pytest
import torch

from svo_tpu_torch.ba import synthetic
from svo_tpu_torch.parallel import ba as tdist
from svo_tpu_torch.parallel import multihost
from torch_dist import run_ranks, world_of_one

torch.set_num_threads(2)


def test_two_process_distributed_ba(tmp_path):
    def argv(rank, port):
        return ["-m", "svo_tpu_torch.multihost_ba_worker", "--rank", str(rank), "--nprocs", "2",
                "--port", str(port), "--backend", "gloo", "--device", "cpu", "--timeout", "120",
                "--out", str(tmp_path / f"mh_{rank}.json"),
                "--arrays", str(tmp_path / f"mh_{rank}.npz")]

    run_ranks(argv, 2, timeout=240)
    problem = synthetic.ba_problem(42, n_cams=6, n_pts=128, noise_px=0.3)
    K = torch.tensor(synthetic.K_MAT)
    with world_of_one():
        one = tdist.solve_ba_distributed(tdist.shard_problem(problem, 8), K,
                                         synthetic.FX * synthetic.BASELINE, iterations=12)
    for r in range(2):
        rep = json.loads((tmp_path / f"mh_{r}.json").read_text())
        assert rep["world"] == 2 and rep["n_local_shards"] == 4 and rep["exchange"] == "direct"
        assert rep["bit_equal_to_one_process"] and rep["ok"], rep
        got = np.load(tmp_path / f"mh_{r}.npz")
        mine = slice(4 * r, 4 * r + 4)
        np.testing.assert_array_equal(got["T_cw"], one.T_cw[mine].numpy())
        np.testing.assert_array_equal(got["points"], one.points[mine].numpy())
        np.testing.assert_array_equal(got["cost"], one.cost[mine].numpy())


def test_put_sharded_needs_the_global_shard_count():
    """A process cannot tell the global shards from its own share by their
    rows, so the caller gives the global count; a leading axis that is
    neither raises rather than solving another problem."""
    problem = synthetic.ba_problem(42, n_cams=6, n_pts=128, noise_px=0.3)
    sharded = tdist.shard_problem(problem, 8)
    K = torch.tensor(synthetic.K_MAT)
    bfx = synthetic.FX * synthetic.BASELINE
    with world_of_one():
        with pytest.raises(TypeError, match="n_shards"):
            multihost.solve_ba_multihost(sharded, K, bfx, device="cpu")
        for wrong in (16, 4, 7):
            with pytest.raises(ValueError):
                multihost.put_sharded(sharded, wrong, device="cpu")
        mine = multihost.put_sharded(sharded, 8, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(mine, sharded))
