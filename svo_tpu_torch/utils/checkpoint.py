"""Checkpoint / resume for the VO pipeline state.

Port of svo_tpu/utils/checkpoint.py, with its signatures: the whole VoState
(features, map, observation ring, pyramid, trajectory, PnP key) goes into
one .npz, so a run can resume mid-sequence with identical downstream
behaviour. The leaves are svo_tpu's, in jax.tree.leaves' order and with
its dtypes (the key as uint32), so either package resumes the other's
checkpoint.
"""

from __future__ import annotations

import numpy as np

from svo_tpu_torch.pipeline.state import VoState, leaves, tensor, to_numpy, unflatten


def save_state(path: str, state: VoState) -> None:
    """Serialise a VoState (single or batched) to an .npz archive."""
    arrays = {f"leaf_{i}": x for i, x in enumerate(leaves(to_numpy(state)))}
    np.savez_compressed(path, **arrays)


def load_state(path: str, example_state: VoState) -> VoState:
    """Restore a VoState saved by save_state (this package's or svo_tpu's)
    onto the device of `example_state`, which supplies the structure and
    the expected shapes (build it with the same Config, e.g. by a
    bootstrap)."""
    with np.load(path) as data:
        restored = []
        for i, ex in enumerate(leaves(example_state)):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(ex.shape):
                raise ValueError(
                    f"checkpoint leaf {i} shape {arr.shape} != expected {tuple(ex.shape)}; "
                    "was the Config (capacities/image size) changed?"
                )
            restored.append(tensor(arr, ex.device).to(ex.dtype))
    return unflatten(restored, example_state)
