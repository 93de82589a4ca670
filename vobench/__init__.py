"""vobench — the benchmark of svo_tpu_torch, the PyTorch and CUDA port.

`python3 -m vobench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json on the card and prints one JSON line. The
harness is driven by data: a configuration is `configs/<name>.json`, a
traffic mix `traffic/<name>.json`, a per-layer metric `metrics/<name>.py`,
and the limits of a cell's output check `limits/<cell>.json`; each is found
by its name. Frames are rendered on the card from the seed (frames.py).
What the timed path produced is held against `reference/`, a frozen plain
PyTorch copy of the port's eager path that imports nothing of the port.

Nothing here imports jax or svo_tpu; svo_tpu_torch is imported only to
drive it (harness.py), never by reference/.
"""
