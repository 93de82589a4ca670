"""Checkpoint / resume for the VO pipeline state.

Port of svo_tpu/utils/checkpoint.py: the whole VoState (features, map,
observation ring, pyramid, trajectory) goes into one .npz, so a run can
resume mid-sequence with identical downstream behaviour. svo_tpu's state
carries its RNG key; the port's PnP noise comes from the engine's
torch.Generator, which lives outside the state, so the checkpoint stores
the generator's state too: without it a resumed run draws other noise and
is no longer the run it was taken from.
"""

from __future__ import annotations

import numpy as np
import torch

from svo_tpu_torch.pipeline.state import VoState, leaves, tensor, unflatten

_GENERATOR = "generator_state"


def save_state(path: str, state: VoState, generator: torch.Generator | None = None) -> None:
    """Serialise a VoState (single or batched) to an .npz archive, with the
    state of `generator` if one is given."""
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves(state))}
    if generator is not None:
        arrays[_GENERATOR] = generator.get_state().numpy()
    np.savez_compressed(path, **arrays)


def load_state(
    path: str, example_state: VoState, generator: torch.Generator | None = None
) -> VoState:
    """Restore a VoState saved by save_state onto the device of
    `example_state`, which supplies the structure and the expected shapes
    (build it with the same Config, e.g. by a bootstrap). If `generator` is
    given it is set to the state the checkpoint holds."""
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
        if generator is not None:
            if _GENERATOR not in data:
                raise ValueError(f"checkpoint {path} holds no generator state")
            generator.set_state(torch.from_numpy(data[_GENERATOR]))
    return unflatten(restored, example_state)
