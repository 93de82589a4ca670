"""KITTI odometry dataset access.

A copy of svo_tpu/io/kitti.py (numpy only; tests/test_torch_io.py holds
the two equal): the stereo layout image_2/%06d.png + image_3/%06d.png read
as grayscale, the ground-truth poses file (12 floats per line, the
row-major top 3x4 of [R|t]), and a synchronous sequence reader. calib.txt
is parsed by svo_tpu_torch.geometry.camera.parse_kitti_calib. The native
prefetcher (svo_tpu_torch.runtime.loader) takes this reader's place where
it can be built.
"""

from __future__ import annotations

import os

import numpy as np


def frame_paths(root: str, idx: int) -> tuple[str, str]:
    """Left/right image paths for frame idx."""
    name = f"{idx:06d}.png"
    return (
        os.path.join(root, "image_2", name),
        os.path.join(root, "image_3", name),
    )


def load_gray(path: str) -> np.ndarray:
    """Load an image as float32 grayscale HxW in [0,255] (PIL's ITU-R 601-2
    luma, the weights of OpenCV's BGR2GRAY)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.float32)


def parse_ground_truth(path: str) -> np.ndarray:
    """Parse a KITTI poses file -> (F,4,4) float64 camera-to-world poses; a
    missing file gives an empty array."""
    if not os.path.exists(path):
        return np.zeros((0, 4, 4), dtype=np.float64)
    rows = np.loadtxt(path, dtype=np.float64)
    if rows.ndim == 1:
        rows = rows[None]
    F = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (F, 1, 1))
    poses[:, :3, :4] = rows.reshape(F, 3, 4)
    return poses


class SequenceReader:
    """Synchronous stereo sequence reader: yields (idx, left, right) f32
    frames from start to end (all of image_2 if end is None), stopping at
    the first missing pair."""

    def __init__(self, root: str, start: int = 0, end: int | None = None):
        self.root = root
        self.start = start
        if end is None:
            files = sorted(os.listdir(os.path.join(root, "image_2")))
            end = len(files)
        self.end = end

    def __len__(self) -> int:
        return self.end - self.start

    def __iter__(self):
        for i in range(self.start, self.end):
            left, right = frame_paths(self.root, i)
            if not (os.path.exists(left) and os.path.exists(right)):
                return
            yield i, load_gray(left), load_gray(right)
