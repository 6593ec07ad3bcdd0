"""The port's utils/waymo_range_image.py against the JAX package's, on
tests/test_waymo_range_image.py's constructions: each of that file's tests
runs with its four functions replaced by the port's, and every call also
runs JAX's on the same inputs; the two agree within 1e-6 (absolute), and
the JAX tests' own golden checks hold on the port's outputs."""

from __future__ import annotations

import numpy as np
import pytest

from faster_rcnn_pytorch_multimodal_tpu.utils import waymo_range_image as j_wri
from faster_rcnn_pytorch_multimodal_tpu_torch.utils import waymo_range_image as t_wri
from tests import test_waymo_range_image as J

FUNCTIONS = ("compute_inclination", "extract_point_cloud_from_range_image",
             "pixel_pose_transform", "range_image_to_point_cloud")
TESTS = [n for n in dir(J) if n.startswith("test_")]
TOL = 1e-6


@pytest.mark.parametrize("name", TESTS)
def test_jax_constructions_on_the_port(name, monkeypatch):
    calls = []

    def both(fn):
        def run(*args, **kwargs):
            got = getattr(t_wri, fn)(*args, **kwargs)
            want = getattr(j_wri, fn)(*args, **kwargs)
            assert got.shape == want.shape and got.dtype == want.dtype, fn
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=fn)
            calls.append(fn)
            return got

        return run

    for fn in FUNCTIONS:
        monkeypatch.setattr(J, fn, both(fn))
    getattr(J, name)()
    assert calls, name


def test_random_range_image_with_pixel_poses():
    """A 32 x 512 image, 30% of its pixels returns, a yawed and shifted
    extrinsic, random per-pixel poses near a frame pose, intensity and
    elongation: the (N, 5) points within 1e-6 of JAX's."""
    rs = np.random.RandomState(4)
    h, w = 32, 512
    incl = t_wri.compute_inclination(-0.3, 0.05, h)[::-1]
    ri = np.where(rs.rand(h, w) < 0.3, rs.uniform(2, 75, (h, w)), 0.0)
    ext = J._make_extrinsic(yaw=-0.7, t=(1.4, -0.1, 2.1))
    pose6 = np.zeros((h, w, 6))
    pose6[..., :3] = rs.uniform(-0.02, 0.02, (h, w, 3)) + [0.0, 0.0, 1.1]
    pose6[..., 3:] = rs.uniform(-0.3, 0.3, (h, w, 3)) + [310.0, -42.0, 1.0]
    frame = J._make_extrinsic(yaw=1.1, t=(310.0, -42.0, 1.0))
    feats = rs.rand(h, w), rs.rand(h, w)
    args = (ri, ext, incl) + feats
    kw = dict(pixel_pose=t_wri.pixel_pose_transform(pose6), frame_pose=frame)
    got = t_wri.range_image_to_point_cloud(*args, **kw)
    want = j_wri.range_image_to_point_cloud(*args, **kw)
    assert got.shape == want.shape == (int((ri > 0).sum()), 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
