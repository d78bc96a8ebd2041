"""The port's synthetic scenes and labels (kfnet_tpu_torch/data/) against
the JAX package's.

Tolerances: the scene, the trajectory and the intrinsics exactly (the same
numpy generator); rendered rgb and depth within atol 1e-4, except at
sphere silhouettes, where a ray that grazes a sphere (``disc`` near 0)
amplifies float32 rounding, or flips ``disc > 0``: there at most 0.1% of
the pixels may differ by more, and the count is asserted; labels within
1e-5 (relative) of the JAX labels on the same depth, validity exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.data import labels as jlabels
from kfnet_tpu.data import synthetic as jsyn
from kfnet_tpu_torch.data import labels as tlabels
from kfnet_tpu_torch.data import synthetic as tsyn

ATOL = 1e-4
MAX_SILHOUETTE_SHARE = 1e-3


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (3, 20.0)])
def test_scene_and_trajectory_equal_jax(seed, scale):
  got, want = tsyn.make_scene(seed, scale=scale), jsyn.make_scene(
      seed, scale=scale)
  for f in ("centers", "radii", "tex_freq", "tex_phase"):
    np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want,
                                                                      f)))
  assert got.wall_z == want.wall_z
  np.testing.assert_array_equal(
      tsyn.orbit_trajectory(24, seed=seed + 1, scale=scale, duration=0.5),
      np.asarray(jsyn.orbit_trajectory(24, seed=seed + 1, scale=scale,
                                       duration=0.5)))


def _far_pixels(got, want):
  """Pixels where rgb or depth differ by more than ATOL."""
  d_rgb = np.abs(got["images"].numpy() - np.asarray(want["images"]))
  d_depth = np.abs(got["depths"].numpy() - np.asarray(want["depths"]))
  return (d_rgb.max(-1) > ATOL) | (d_depth > ATOL * np.maximum(
      1.0, np.abs(np.asarray(want["depths"]))))


@pytest.mark.parametrize("height,width", [(48, 64), (96, 128)])
def test_make_sequence_matches_jax(height, width):
  kw = dict(height=height, width=width, seed=0, traj_seed=99,
            duration=12 / 48.0)
  got = tsyn.make_sequence(12, device="cpu", **kw)
  want = jsyn.make_sequence(12, **kw)
  for k in ("poses", "K"):
    np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
  far = _far_pixels(got, want)
  assert far.sum() <= MAX_SILHOUETTE_SHARE * far.size, (far.sum(), far.size)
  assert got["images"].shape == (12, height, width, 3)
  assert got["depths"].shape == (12, height, width)
  assert got["images"].dtype == torch.float32
  assert 0.0 <= got["images"].min() and got["images"].max() <= 1.0


def test_render_chunks_and_single_frames_agree(monkeypatch):
  """A frame rendered alone, in a chunk of frames, or in chunks of two
  (the renderer's memory bound) gives the same bits."""
  whole = tsyn.make_sequence(5, 24, 32, seed=1, device="cpu")
  assert tsyn.render_chunk(480, 640) == 3  # 640x480: 3 frames a call
  monkeypatch.setattr(tsyn, "RENDER_BYTES",
                      2 * tsyn.LIVE_INTERMEDIATES * 24 * 32 * 48 * 4)
  assert tsyn.render_chunk(24, 32) == 2
  chunked = tsyn.make_sequence(5, 24, 32, seed=1, device="cpu")
  for k in ("images", "depths"):
    assert torch.equal(whole[k], chunked[k]), k
  rgb, depth = tsyn.render(tsyn.make_scene(1), whole["poses"][3], whole["K"],
                           24, 32)
  assert torch.equal(rgb, whole["images"][3])
  assert torch.equal(depth, whole["depths"][3])


def test_labels_match_jax(tmp_path):
  data = jsyn.make_sequence(3, 96, 128, seed=0)
  coords, valids = [], []
  for f in range(3):
    depth = np.asarray(data["depths"][f]).copy()
    depth[:10] = 0.0   # an invalid band
    depth[50, 60] = 50.0  # beyond max_depth
    args = (depth, np.asarray(data["K"]), np.asarray(data["poses"][f]))
    c, v = tlabels.generate(*(torch.from_numpy(np.array(a)) for a in args))
    jc, jv = jlabels.generate(*(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    assert c.shape == (12, 16, 3) and not v.all()
    coords.append(c.numpy())
    valids.append(v.numpy())
  mean, std = tlabels.scene_statistics(coords, valids)
  jmean, jstd = jlabels.scene_statistics(coords, valids)
  np.testing.assert_array_equal(mean, jmean)
  assert std == jstd
  path = str(tmp_path / "l" / "f0.npz")
  tlabels.save(path, coords[0], valids[0])
  c0, v0 = jlabels.load(path)
  np.testing.assert_array_equal(c0, coords[0])
  np.testing.assert_array_equal(v0, valids[0])
  with pytest.raises(ValueError, match="no valid"):
    tlabels.scene_statistics([coords[0]], [np.zeros_like(valids[0])])
