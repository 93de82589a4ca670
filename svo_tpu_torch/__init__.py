"""svo_tpu_torch — the stereo visual-odometry system of svo_tpu, ported to
PyTorch and CUDA.

The package mirrors svo_tpu's layout (ops/, geometry/, pipeline/,
parallel/, ba/, io/, eval/, utils/, viz/, runtime/) so each module's
counterpart is easy to find, and has its own entry points
(python3 -m svo_tpu_torch.run_synthetic, .run_kitti, .run_euroc);
svo_tpu stays the reference the port is tested against. It imports torch
and never jax or svo_tpu, so it runs on a machine without jax. The
hand-written kernels (csrc/*.cu) are built with nvcc at first use (see
_build.py).
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry (PnP, triangulation, SE(3)) needs true f32 products, as svo_tpu
# forces with jax_default_matmul_precision="float32". TF32 keeps ~3 decimal
# digits: switch it off for matmuls and for cuDNN convolutions (which
# default to TF32 on the card).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# The back-end's batched dense solves (torch.linalg.solve_ex: the blocks'
# Schur systems, 4 blocks x S at 42x42, the 22-node pose graph at 132x132
# x S) are captured in CUDA graphs. torch's default linalg backend hands a
# batch of more than 16 systems, or systems past 128 rows, to MAGMA, whose
# batched LU cannot be captured; cuSOLVER's preference keeps them on
# cuBLAS's batched LU (cusolver for a single system), which can. Eager
# calls take the same library, so a captured solve is the eager one.
if _torch.version.cuda is not None:  # a CPU-only build has no cuSOLVER to prefer
    _torch.backends.cuda.preferred_linalg_library("cusolver")

from svo_tpu_torch.config import Config, load_config  # noqa: E402,F401
