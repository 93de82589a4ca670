"""The plain reference of the benchmark's output check.

A frozen copy of svo_tpu_torch's eager plain path, taken when the
benchmark was defined: config, the frame step and bootstrap
(pipeline/frontend.py, pipeline/state.py), the detectors, pyramids, KLT,
PnP, triangulation and index ops (ops/, geometry/), the window BA and the
global refiner (ba/, parallel/global_opt.py). Every kernel wrapper
(ops/klt_patches.extract_klt_patches, ops/lk_fused.lk_track_level and
lk_track_pyramid, ops/random.split_gumbel) runs its plain PyTorch version on
every device, and nothing is captured: each op is issued from the host.
The copy imports nothing of svo_tpu_torch, jax or svo_tpu, and takes
nothing the program made but, where a checked stretch starts mid-run, the
program's state before it (drive.py).

Later changes to the port do not reach this copy: it is the yardstick.
"""
