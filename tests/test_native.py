"""Native C++ image-loader tests (skipped if the toolchain is unavailable)."""

import numpy as np
import pytest

from admm_deconv.data import ImageDataFeeder, save_image
from admm_deconv.data import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native loader not buildable"
)


@pytest.fixture
def png_dirs(tmp_path, rng):
    xd, yd = tmp_path / "x", tmp_path / "y"
    xd.mkdir()
    yd.mkdir()
    imgs = []
    for i in range(3):
        img = (rng.random((40, 48, 3)) * 0.8).astype(np.float32)
        imgs.append(img)
        save_image(str(yd / f"{i}.png"), img)
        save_image(str(xd / f"{i}.png"), img + 0.1)
    return str(xd), str(yd), imgs


class TestNativeLoader:
    def test_image_size(self, png_dirs):
        xd, yd, _ = png_dirs
        import glob, os

        path = sorted(glob.glob(os.path.join(yd, "*.png")))[0]
        assert native.image_size(path) == (40, 48)

    def test_batch_shapes_and_range(self, png_dirs):
        xd, yd, _ = png_dirs
        import glob, os

        xs = sorted(glob.glob(os.path.join(xd, "*.png")))
        ys = sorted(glob.glob(os.path.join(yd, "*.png")))
        bx, by = native.load_pair_batch(xs, ys, 32, 32, seed=7)
        assert bx.shape == by.shape == (3, 32, 32, 3)
        assert bx.dtype == np.float32
        assert 0.0 <= by.min() and by.max() <= 1.0

    def test_crop_alignment_and_determinism(self, png_dirs):
        xd, yd, _ = png_dirs
        import glob, os

        xs = sorted(glob.glob(os.path.join(xd, "*.png")))
        ys = sorted(glob.glob(os.path.join(yd, "*.png")))
        bx, by = native.load_pair_batch(xs, ys, 16, 16, seed=42)
        # x = y + 0.1 everywhere -> aligned crops keep a constant offset.
        np.testing.assert_allclose(bx - by, 0.1, atol=2 / 255)
        bx2, by2 = native.load_pair_batch(xs, ys, 16, 16, seed=42)
        np.testing.assert_array_equal(by, by2)
        _, by3 = native.load_pair_batch(xs, ys, 16, 16, seed=43)
        assert not np.array_equal(by, by3)

    def test_matches_pil_decode(self, png_dirs):
        """Native decode must agree with PIL byte-for-byte (both 8-bit)."""
        xd, yd, imgs = png_dirs
        import glob, os

        ys = sorted(glob.glob(os.path.join(yd, "*.png")))
        by, by2 = native.load_pair_batch(ys, ys, 40, 48, seed=0)
        from admm_deconv.data import load_image

        for i, path in enumerate(ys):
            pil = load_image(path)
            np.testing.assert_allclose(by[i], pil, atol=1e-6)

    def test_oversize_crop_errors(self, png_dirs):
        xd, yd, _ = png_dirs
        import glob, os

        ys = sorted(glob.glob(os.path.join(yd, "*.png")))
        with pytest.raises(IOError, match="crop larger"):
            native.load_pair_batch(ys, ys, 100, 100, seed=0)

    def test_missing_file_errors(self):
        with pytest.raises(IOError, match="open"):
            native.load_pair_batch(["/nope/a.png"], ["/nope/b.png"], 8, 8, seed=0)

    def test_feeder_native_backend(self, png_dirs):
        xd, yd, _ = png_dirs
        feeder = ImageDataFeeder(
            xd, yd, ".png", (24, 24), (24, 24),
            rng=np.random.default_rng(0), backend="native",
        )
        bx, by = feeder[[0, 2]]
        assert bx.shape == (2, 24, 24, 3)
        np.testing.assert_allclose(bx - by, 0.1, atol=2 / 255)

    def test_feeder_backend_agreement(self, png_dirs):
        """Native and PIL backends produce identically-distributed batches
        (same images, different crop RNG streams)."""
        xd, yd, _ = png_dirs
        nat = ImageDataFeeder(
            xd, yd, ".png", (40, 48), (40, 48), backend="native",
            rng=np.random.default_rng(0),
        )
        pil = ImageDataFeeder(
            xd, yd, ".png", (40, 48), (40, 48), backend="pil",
            rng=np.random.default_rng(0),
        )
        bn, _ = nat[[0]]
        bp, _ = pil[[0]]
        # Full-size crop -> whole image -> identical regardless of RNG.
        np.testing.assert_allclose(bn, bp, atol=1e-6)
