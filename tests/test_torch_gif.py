"""PyTorch port, GIF assembly (runners/gif.py, a copy of the JAX package's):
the bytes equal the JAX writer's, and a standard decoder (PIL) reads them
back exactly."""

import numpy as np
import pytest

from wgpu_n_body_tpu.runners.gif import write_gif as jax_write_gif
from wgpu_n_body_tpu_torch.runners.gif import write_gif

PIL = pytest.importorskip("PIL.Image")


def _frames(kind):
    rng = np.random.RandomState(0)
    if kind == "u8":
        return [rng.randint(0, 256, (37, 53)).astype(np.uint8) for _ in range(3)]
    if kind == "float":  # _to_u8's + 0.5 rounding, where png_bytes truncates
        return [np.linspace(-0.1, 1.1, 64 * 64, dtype=np.float32).reshape(64, 64)]
    frame = np.random.RandomState(1).randint(0, 256, (256, 256)).astype(np.uint8)
    return [frame, 255 - frame]  # > 4096 LZW phrases: the dictionary reset


@pytest.mark.parametrize("kind", ["u8", "float", "reset"])
def test_gif_bytes_equal_jax_and_decode_exactly(tmp_path, kind):
    frames = _frames(kind)
    ours, theirs = str(tmp_path / "port.gif"), str(tmp_path / "jax.gif")
    write_gif(ours, frames, fps=20)
    jax_write_gif(theirs, frames, fps=20)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    img = PIL.open(ours)
    assert getattr(img, "n_frames", 1) == len(frames)
    for i, f in enumerate(frames):
        img.seek(i)
        want = f if f.dtype == np.uint8 else (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(np.asarray(img.convert("L")), want)


def test_gif_rejects_empty_and_mismatched(tmp_path):
    with pytest.raises(ValueError):
        write_gif(str(tmp_path / "x.gif"), [])
    with pytest.raises(ValueError):
        write_gif(str(tmp_path / "y.gif"),
                  [np.zeros((4, 4), np.uint8), np.zeros((5, 4), np.uint8)])
