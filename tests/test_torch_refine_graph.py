"""The compiled back-end (svo_tpu_torch/parallel/global_opt.py::
make_refine_global, svo_tpu_torch/ba/solver.py::make_solve_ba), on the CPU.

svo_tpu jits its global refiner with the state donated and takes the
aggressive regime's branch inside it (lax.cond); bench.py jits its BA
stage. The port's refiner runs the conservative stage as one graph, reads
the regime (`aggressive.any()`) once on the host, and replays one graph per
regime over static buffers; the solve is one graph. On the CPU the same
static-buffer code runs eagerly. These tests hold it, on
test_torch_global_opt.py's drifted (aggressive) and near-GT (healthy)
fixtures (22 frames, 4 blocks of 7 cameras):

(a) bit-equal to refine_global (graph=False) in every leaf of the result:
    one stream in each regime, and a stack of S=2 with one stream in each;
(b) against svo_tpu's jitted refine_global on the same numpy inputs, within
    test_torch_global_opt.py's bounds (decisions equal, costs at COST_RTOL,
    poses 1e-3 m, the healthy span's points 2e-3 m; the aggressive span's
    points are held there against refine_global, which (a) equals);
(c) BatchedStereoVO.refine() with the default graph against graph=False
    over a short 2-stream run (96x256) with a sweep after every chunk and
    one on a bent stream, bit-equal in every leaf of the state;
(d) exactly one host read a sweep (the patched regime read, every other
    read of a tensor's value refused);
(e) the donated contract: the result's map and poses are the refiner's
    state buffers and the rest its own buffers, a clone survives the next
    call, the caller's tensors are only read, and a result fed back in is
    not copied in again; graph=True refused on the CPU; a first call whose
    capture fails keeps no graph (captures faked);
(f) make_solve_ba bit-equal to solve_ba, problem after problem through one
    solver, and within test_torch_ba.py's 4-iteration bounds of svo_tpu's
    jax.jit(solve_ba).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svo_tpu.ba import solver as jsolver
from svo_tpu.parallel import global_opt as jglobal
from svo_tpu_torch.ba import solver as tsolver
from svo_tpu_torch.config import Config
from svo_tpu_torch.geometry import camera as tcam
from svo_tpu_torch.parallel import global_opt as tglobal
from svo_tpu_torch.parallel.batched import BatchedStereoVO
from svo_tpu_torch.pipeline import graph as tgraph
from svo_tpu_torch.pipeline.graph import PRE
from svo_tpu_torch.pipeline.state import MapState, clone, leaves
from test_global_opt import make_drifted_state
from test_torch_ba import BFX as BA_BFX
from test_torch_ba import K_J, PROBLEMS, _pair
from test_torch_ba import K_T as BA_K
from test_torch_checkpoint import KW as SMALL
from test_torch_checkpoint import REFINER, data  # noqa: F401 (fixture)
from test_torch_global_opt import BFX, COST_RTOL, FIXTURES, K_T, KW, N, _close, _tmap

torch.set_num_threads(2)

HI = torch.tensor(N - 1, dtype=torch.int32)


def _equal(a, b) -> bool:
    xs, ys = leaves(a), leaves(b)
    return len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))


def _stack(states):
    mp = MapState(*(torch.stack(xs) for xs in zip(*(s[0] for s in states))))
    return (mp, torch.stack([s[1] for s in states]),
            torch.full((len(states),), N - 1, dtype=torch.int32))


@pytest.fixture(scope="module")
def fixtures():
    """Each fixture's state (test_torch_global_opt.py's seeds) and
    svo_tpu's jitted refine_global on it."""
    jitted = jax.jit(functools.partial(jglobal.refine_global, **KW))
    out = {}
    for i, (name, kw) in enumerate(FIXTURES.items()):
        if name == "exact":
            continue
        mp, poses, _, _ = make_drifted_state(np.random.default_rng(42 + i), n_frames=N, **kw)
        rj = jitted(mp, poses, jnp.int32(N - 1), jnp.asarray(K_T.numpy()), jnp.float32(BFX))
        out[name] = dict(state=(_tmap(mp), torch.tensor(np.asarray(poses))),
                         rj=jax.tree.map(np.asarray, rj))
    return out


def _inputs(fixtures, names):
    if len(names) == 1:
        return (*fixtures[names[0]]["state"], HI)
    return _stack([fixtures[n]["state"] for n in names])


CASES = {"drifted": ("drifted",), "near_gt": ("near_gt",), "S2_mixed": ("near_gt", "drifted")}


# ----------------------------------------------------------------------- (a)

@pytest.mark.parametrize("case", CASES)
def test_refiner_bit_equal_to_refine_global(fixtures, case):
    names = CASES[case]
    inputs = _inputs(fixtures, names)
    want = tglobal.refine_global(*inputs, K_T, BFX, **KW)
    refine = tglobal.make_refine_global(K_T, BFX, **KW)
    assert isinstance(refine, tglobal.CapturedRefine) and not refine.graph.capture
    got = refine(*inputs)
    assert _equal(got, want)
    assert isinstance(got, tglobal.RefineResult) and got.accepted.shape == want.accepted.shape
    eager = tglobal.make_refine_global(K_T, BFX, graph=False, **KW)
    assert _equal(eager(*inputs), want)


# ----------------------------------------------------------------------- (b)

@pytest.mark.parametrize("name", ["drifted", "near_gt"])
def test_refiner_matches_svo_tpu(fixtures, name):
    rj = fixtures[name]["rj"]
    rt = tglobal.make_refine_global(K_T, BFX, **KW)(*_inputs(fixtures, (name,)))
    aggressive = float(rt.cost_per_obs) > 10.0
    assert aggressive == (float(rj.cost_per_obs) > 10.0) == (name == "drifted")
    assert bool(rt.accepted) == bool(rj.accepted) and int(rt.frame_lo) == int(rj.frame_lo) == 0
    for f, rtol in COST_RTOL.items():
        if f == "span_cost" and aggressive:
            rtol = 1e-2
        assert _close(getattr(rj, f), getattr(rt, f).numpy(), rtol), (f, getattr(rj, f), getattr(rt, f))
    assert np.array_equal(rj.ba_cost <= rj.ba_cost0, (rt.ba_cost <= rt.ba_cost0).numpy())
    np.testing.assert_allclose(rt.poses.numpy(), rj.poses, atol=1e-3)
    if not aggressive:
        assert np.abs(rt.map.points.numpy() - rj.map.points).max() < 2e-3


# ----------------------------------------------------------------------- (c)

def _bent(state, s: int = 1, n: int = 8):
    """Stream s's last n poses bent by a growing yaw and side slip (drift)."""
    poses = state.poses.clone()
    hi = int(state.frame_id[s])
    for k, f in enumerate(range(hi - n + 1, hi + 1)):
        a = 0.01 * (k + 1)
        bend = torch.eye(4)
        bend[0, 0], bend[0, 2], bend[2, 0], bend[2, 2] = np.cos(a), np.sin(a), -np.sin(a), np.cos(a)
        bend[0, 3] = 0.03 * (k + 1)
        poses[s, f] = poses[s, f] @ bend
    pose = state.pose.clone()
    pose[s] = poses[s, hi]
    return state._replace(poses=poses, pose=pose)


def test_batched_refine_bit_equal_to_eager(data):
    """2 streams, 2 chunks of 6 with a sweep after each, then a sweep with
    stream 1 bent (the aggressive branch): states, verdicts and the last
    RefineResult bit-equal to the engine with graph=False."""
    cam = tcam.from_intrinsics(120.0, 120.0, 128.0, 48.0, data["baseline"])
    runs = []
    for graph in (False, None):
        bvo = BatchedStereoVO(Config(**SMALL), cam, 2, chunk=6, kf_cadence=6, device="cpu",
                              graph=graph)
        bvo.make_refiner(**REFINER)
        bvo.start(*data["first"])
        out = []
        for c in range(2):
            bvo.process_chunk(*data["chunks"][c])
            out.append((bvo.refine(), clone(bvo.state), clone(bvo.last_refine)))
        bvo.state = _bent(bvo.state)
        out.append((bvo.refine(), clone(bvo.state), clone(bvo.last_refine)))
        runs.append((bvo, out))
    (_, eager), (static, captured) = runs
    assert isinstance(static.refiner, tglobal.CapturedRefine)
    for (acc_a, st_a, res_a), (acc_b, st_b, res_b) in zip(eager, captured):
        assert np.array_equal(acc_a, acc_b)
        assert _equal(st_a, st_b) and _equal(res_a, res_b)
    regimes = [(r.cost_per_obs > 10.0).tolist() for _, _, r in captured]
    assert regimes[-1] == [False, True], regimes   # both regimes in the last sweep
    assert captured[-1][0][1], "the bent stream was not rebuilt"
    # the state holds the refiner's buffers, the rest the chunk step's
    st, buf = static.state, static.refiner.graph.state
    assert st.poses is buf[1] and st.map.points is buf[0].points
    assert st.features.pos is static._chunk_step.state.features.pos


# ----------------------------------------------------------------------- (d)

def _count_reads(monkeypatch) -> list:
    """Patch the refiner's regime read to count its calls, and refuse every
    other read of a tensor's value."""
    tolist = torch.Tensor.tolist
    reads = []

    def read(flag):
        reads.append(1)
        return bool(tolist(flag))

    def no_sync(*_a, **_k):
        raise AssertionError("host read of a tensor value outside the regime")

    monkeypatch.setattr(tglobal, "_read_regime", read)
    for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_sync)
    return reads


def test_one_regime_read_a_sweep(fixtures, monkeypatch):
    refine = tglobal.make_refine_global(K_T, BFX, **KW)
    stacked = tglobal.make_refine_global(K_T, BFX, **KW)
    reads = _count_reads(monkeypatch)
    refine(*_inputs(fixtures, ("near_gt",)))
    refine(*_inputs(fixtures, ("drifted",)))
    assert len(reads) == 2
    stacked(*_inputs(fixtures, ("near_gt", "drifted")))
    assert len(reads) == 3
    tglobal.refine_global(*_inputs(fixtures, ("drifted",)), K_T, BFX, **KW)
    assert len(reads) == 4  # the eager reference reads the same once


# ----------------------------------------------------------------------- (e)

def test_donated_contract(fixtures, monkeypatch):
    refine = tglobal.make_refine_global(K_T, BFX, **KW)
    first = _inputs(fixtures, ("near_gt", "drifted"))
    second = _inputs(fixtures, ("drifted", "near_gt"))
    before = [x.clone() for x in leaves(first)]
    out = refine(*first)
    # the caller's tensors are only read
    assert all(torch.equal(x, y) for x, y in zip(leaves(first), before))
    graph = refine.graph
    (mp, poses, _), rest = graph.state, graph.extra
    assert all(x is y for x, y in zip(out.map, mp)) and out.poses is poses
    assert all(x is y for x, y in zip(out[2:], rest))
    assert set(graph.pre_out._fields) >= {"aggressive", "any_aggressive"}
    kept = clone(out)
    again = refine(*second)
    assert again.poses is out.poses                       # the same buffers, rewritten
    assert _equal(kept, tglobal.refine_global(*first, K_T, BFX, **KW))
    assert _equal(again, tglobal.refine_global(*second, K_T, BFX, **KW))
    # a result fed back in is not copied in again (the first copy of a
    # call is the state's), and gives the eager bits
    copied = []
    orig = tgraph._copy_into

    def spy(dst, src):
        copied.append(sum(not tgraph._is(s, d) for d, s in zip(dst, src)))
        orig(dst, src)

    monkeypatch.setattr(tgraph, "_copy_into", spy)
    want = tglobal.refine_global(again.map, again.poses, graph.state[2], K_T, BFX, **KW)
    fed = refine(again.map, again.poses, graph.state[2])
    assert copied[0] == 0 and _equal(fed, want)
    # one stream rides as a stack of one: its leaves are views of the
    # buffers, and fed back in they are not copied either
    one = tglobal.make_refine_global(K_T, BFX, **KW)
    res = one(*_inputs(fixtures, ("drifted",)))
    assert res.poses.data_ptr() == one.graph.state[1].data_ptr() and res.poses.dim() == 3
    copied.clear()
    one(res.map, res.poses, HI)
    assert copied[0] == 1  # frame_hi, a tensor of the caller's
    assert sorted(graph.graphs) == [] and graph.capture_s == {}  # nothing captured on the CPU
    assert PRE == "pre" and tglobal.CapturedRefine.REGIMES == ("healthy", "aggressive")


def test_graph_true_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        tglobal.make_refine_global(K_T, BFX, graph=True)
    with pytest.raises(ValueError, match="CUDA"):
        tsolver.make_solve_ba(BA_K, BA_BFX, graph=True)
    assert callable(tglobal.make_refine_global(K_T, BFX, graph=False))
    assert not isinstance(tsolver.make_solve_ba(BA_K, BA_BFX, graph=False), tsolver.CapturedSolve)


@pytest.mark.parametrize("pre", [True, False], ids=["pre", "no_pre"])
def test_failed_first_call_keeps_no_graph(monkeypatch, pre):
    """A first call captures several graphs (the first stage, every other
    key, then the key read). When one capture fails, the call raises and
    keeps none of them: the retry captures all again and replays nothing
    recorded over the dropped buffers. Captures are faked on the CPU."""
    log, fail = [], {"a"}

    class Fake:
        def __init__(self, name):
            self.name = name

        def replay(self):
            log.append(("replay", self.name))

    def capture(self, name, body):
        body()
        log.append(("capture", name))
        if name in fail:
            raise RuntimeError(f"capture of {name} failed")
        self.graphs[name] = Fake(name)
        self.capture_s[name] = 0.0
        self.launches_per_replay[name] = {f.__name__: 0 for f in tgraph.COUNTED}
        self._pool = self._pool or object()

    monkeypatch.setattr(tgraph.StepGraph, "_capture", capture)

    def run(state, key, *stage):
        return (state[0] + (1.0 if key == "a" else 2.0),), (state[0] * 2,)

    step = tgraph.StepGraph(run, None, "cpu", key=lambda *_: "a",
                            pre=(lambda s: (s[0] * 3,)) if pre else None, extra=True,
                            keys=("a", "b"))
    step.capture = True
    first = [("capture", n) for n in ((PRE,) if pre else ()) + ("b", "a")]
    with pytest.raises(RuntimeError, match="capture of a failed"):
        step((torch.zeros(3),))
    assert log == first
    assert step.state is None and step.graphs == {} and step.capture_s == {}
    assert step.launches_per_replay == {} and step._pool is None
    fail.clear()
    log.clear()
    step((torch.zeros(3),))
    assert log == first                       # captured again, nothing replayed
    log.clear()
    step((torch.zeros(3),))
    assert log == [("replay", n) for n in ((PRE,) if pre else ()) + ("a",)]


# ----------------------------------------------------------------------- (f)

@pytest.mark.parametrize("name", PROBLEMS)
def test_captured_solve_ba(name):
    kw = dict(PROBLEMS[name])
    solve = tsolver.make_solve_ba(BA_K, BA_BFX, iterations=4)
    assert isinstance(solve, tsolver.CapturedSolve) and not solve.graph.capture
    jitted = jax.jit(functools.partial(jsolver.solve_ba, iterations=4))
    pj, pt = _pair(**kw)
    b = solve(pt)
    assert _equal(b, tsolver.solve_ba(pt, BA_K, BA_BFX, iterations=4))
    assert all(x is y for x, y in zip(b, solve.graph.extra))  # the solver's buffers
    a = jitted(pj, K_J, jnp.float32(BA_BFX))
    assert int(a.n_obs) == int(b.n_obs)
    assert abs(float(a.cost0) - float(b.cost0)) <= 1e-5 * abs(float(a.cost0))
    assert abs(float(a.cost) - float(b.cost)) <= 1e-3 * abs(float(a.cost))
    assert float(np.abs(np.asarray(a.T_cw) - b.T_cw.numpy()).max()) < 1e-4
    dist = np.linalg.norm(np.asarray(a.points), axis=-1, keepdims=True)
    assert float((np.abs(np.asarray(a.points) - b.points.numpy()) / dist).max()) < 1e-4
    # a second problem of the same shapes through the same buffers
    kw["seed"] += 10
    _, pt2 = _pair(**kw)
    kept = tsolver.BAResult(*(x.clone() for x in b))
    b2 = solve(pt2)
    assert _equal(b2, tsolver.solve_ba(pt2, BA_K, BA_BFX, iterations=4))
    assert not _equal(b2, kept) and b2.T_cw is b.T_cw
