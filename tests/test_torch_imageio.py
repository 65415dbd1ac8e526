"""The port's image codecs (``csrc/imageio.cpp`` via ``data/imageio.py``)
against OpenCV, on the host.

* PNGs (RGB and gray) and JPEGs that ``cv2.imwrite`` wrote, at several
  sizes including InterHand's 334x512 and odd ones, and JPEGs at other
  chroma samplings, restart intervals, optimised tables and qualities,
  decode to exactly what ``cv2.imread`` gives: the JPEG decoder follows
  libjpeg-turbo's islow IDCT, fancy upsampling and fixed-point colour
  conversion, so no tolerance is needed;
* PNGs from the port's writer decode exactly to their source, through
  the port and through cv2; JPEGs from the port's writer decode
  identically through both, and a smooth frame within JPEG quantisation
  of its source (PSNR >= 40 dB);
* ``decode_padded`` zero-pads each image's slot;
* a missing, corrupt, progressive or wrongly sized file raises naming
  its path; ``out`` is checked as the JAX bridge checks it.
"""

import os

import numpy as np
import pytest

from handpose_tpu_torch.data import imageio
from _torch_port import port_worker_niced  # noqa: F401

cv2 = pytest.importorskip("cv2")

SIZES = [(320, 320), (334, 512), (512, 334), (37, 51), (17, 9), (1, 1)]


def _rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


def _image(h, w, seed, smooth=False):
    rng = np.random.default_rng(seed)
    if not smooth:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 100 * np.sin(x / 37.0 + c) * np.cos(y / 53.0 - c)
                    for c in range(3)], -1)
    return img.astype(np.uint8)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_decodes_cv2_files_as_cv2_reads_them(tmp_path, hw, ext):
    h, w = hw
    img = _image(h, w, seed=h * w)
    path = str(tmp_path / f"a.{ext}")
    cv2.imwrite(path, img[:, :, ::-1])
    np.testing.assert_array_equal(imageio.decode_batch([path], h, w)[0],
                                  _rgb(path))
    gray = str(tmp_path / f"g.{ext}")
    cv2.imwrite(gray, img[..., 1])
    np.testing.assert_array_equal(imageio.decode_batch([gray], h, w, 1)[0],
                                  cv2.imread(gray, cv2.IMREAD_GRAYSCALE))
    # a gray file read as RGB, a colour JPEG read as gray (its Y plane)
    np.testing.assert_array_equal(imageio.decode_batch([gray], h, w)[0],
                                  _rgb(gray))
    if ext == "jpg":
        np.testing.assert_array_equal(
            imageio.decode_batch([path], h, w, 1)[0],
            cv2.imread(path, cv2.IMREAD_GRAYSCALE))


JPEG_VARIANTS = {
    "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
    "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
    "440": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440],
    "411": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "q50": [cv2.IMWRITE_JPEG_QUALITY, 50],
    "q100": [cv2.IMWRITE_JPEG_QUALITY, 100],
}


@pytest.mark.parametrize("variant", sorted(JPEG_VARIANTS))
def test_jpeg_variants_decode_as_cv2_reads_them(tmp_path, variant):
    h, w = 334, 51
    img = _image(h, w, seed=3)
    path = str(tmp_path / "v.jpg")
    cv2.imwrite(path, img[:, :, ::-1], JPEG_VARIANTS[variant])
    np.testing.assert_array_equal(imageio.decode_batch([path], h, w)[0],
                                  _rgb(path))


def test_png_variants_decode_as_cv2_reads_them(tmp_path):
    """16-bit (high byte kept), alpha (dropped), palette and 1-bit."""
    rng = np.random.default_rng(4)
    cases = {
        "rgb16.png": rng.integers(0, 65536, (33, 47, 3), dtype=np.uint16),
        "rgba.png": rng.integers(0, 256, (33, 47, 4), dtype=np.uint8),
        "gray16.png": rng.integers(0, 65536, (33, 47), dtype=np.uint16),
    }
    for name, arr in cases.items():
        path = str(tmp_path / name)
        cv2.imwrite(path, arr)
        np.testing.assert_array_equal(imageio.decode_batch([path], 33, 47)[0],
                                      _rgb(path))
    PIL = pytest.importorskip("PIL.Image")
    for mode in ("P", "1", "LA"):
        path = str(tmp_path / f"pil_{mode}.png")
        PIL.fromarray(_image(33, 47, seed=5)).convert(mode).save(path)
        np.testing.assert_array_equal(imageio.decode_batch([path], 33, 47)[0],
                                      _rgb(path))


@pytest.mark.parametrize("hw", [(320, 320), (334, 512), (7, 5)])
def test_png_writer_round_trips_exactly(tmp_path, hw):
    h, w = hw
    img = _image(h, w, seed=6)
    mask = img[..., 0] // 8
    cpath, mpath = str(tmp_path / "c.png"), str(tmp_path / "m.png")
    imageio.write_png(cpath, img)
    imageio.write_png(mpath, mask)
    np.testing.assert_array_equal(imageio.decode_batch([cpath], h, w)[0],
                                  img)
    np.testing.assert_array_equal(_rgb(cpath), img)
    np.testing.assert_array_equal(imageio.decode_batch([mpath], h, w, 1)[0],
                                  mask)
    np.testing.assert_array_equal(cv2.imread(mpath, cv2.IMREAD_GRAYSCALE),
                                  mask)


@pytest.mark.parametrize("hw", [(512, 334), (334, 512), (9, 13)])
def test_jpeg_writer_decodes_as_cv2_reads_it(tmp_path, hw):
    h, w = hw
    for smooth in (False, True):
        img = _image(h, w, seed=7, smooth=smooth)
        path = str(tmp_path / "w.jpg")
        imageio.write_jpeg(path, img)
        got = imageio.decode_batch([path], h, w)[0]
        np.testing.assert_array_equal(got, _rgb(path))
        if smooth and h > 16:
            mse = ((got.astype(np.float64) - img) ** 2).mean()
            assert 10 * np.log10(255.0 ** 2 / mse) >= 40.0
    gray = str(tmp_path / "g.jpg")
    imageio.write_jpeg(gray, img[..., 2])
    np.testing.assert_array_equal(imageio.decode_batch([gray], h, w, 1)[0],
                                  cv2.imread(gray, cv2.IMREAD_GRAYSCALE))


def test_decode_padded_zero_pads_each_slot(tmp_path):
    sizes = [(40, 24), (24, 40), (40, 40), (7, 3)]
    paths, imgs = [], []
    for i, (h, w) in enumerate(sizes):
        img = _image(h, w, seed=i) | 1          # no zero pixel inside
        p = str(tmp_path / f"{i}.{'png' if i % 2 else 'jpg'}")
        cv2.imwrite(p, img[:, :, ::-1])
        paths.append(p)
        imgs.append(_rgb(p))
    out = np.full((4, 48, 40, 3), 77, np.uint8)      # stale bytes
    got = imageio.decode_padded(paths, sizes, (48, 40), n_threads=3,
                                out=out)
    assert got is out
    for i, (h, w) in enumerate(sizes):
        np.testing.assert_array_equal(got[i, :h, :w], imgs[i])
        assert not got[i, h:].any() and not got[i, :, w:].any()
    with pytest.raises(ValueError, match="does not fit"):
        imageio.decode_padded(paths, sizes, (39, 40))


def test_bad_files_raise_naming_their_path(tmp_path):
    good = str(tmp_path / "good.png")
    cv2.imwrite(good, _image(20, 30, seed=8))
    jpg = str(tmp_path / "good.jpg")
    cv2.imwrite(jpg, _image(20, 30, seed=8))
    prog = str(tmp_path / "prog.jpg")
    cv2.imwrite(prog, _image(20, 30, seed=8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    cut_png = str(tmp_path / "cut.png")
    cut_jpg = str(tmp_path / "cut.jpg")
    for src, dst in ((good, cut_png), (jpg, cut_jpg)):
        with open(src, "rb") as f:
            data = f.read()
        with open(dst, "wb") as f:
            f.write(data[:len(data) // 2])
    text = str(tmp_path / "text.png")
    with open(text, "w") as f:
        f.write("not an image")
    cases = [(str(tmp_path / "missing.png"), "cannot read"),
             (cut_png, "corrupt PNG"), (cut_jpg, "corrupt JPEG"),
             (text, "not a PNG or JPEG"), (prog, "progressive")]
    for path, why in cases:
        with pytest.raises(OSError, match=why) as e:
            imageio.decode_batch([good, path, good], 20, 30, n_threads=2)
        assert os.path.basename(path) in str(e.value)
    # the annotated size is checked against the file's
    with pytest.raises(OSError, match=r"good.jpg.*20x30.*expected 20x31"):
        imageio.decode_padded([good, jpg], [(20, 30), (20, 31)], (20, 31))


def test_out_buffer_is_checked(tmp_path):
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, _image(8, 8, seed=9))
    for bad, why in ((np.zeros((1, 8, 8, 3), np.int16), "uint8"),
                     (np.zeros((1, 8, 8, 4), np.uint8)[..., :3],
                      "C-contiguous"),
                     (np.zeros((1, 8, 9, 3), np.uint8), "elements")):
        with pytest.raises(ValueError, match=why):
            imageio.decode_batch([path], 8, 8, out=bad)
    ro = np.zeros((1, 8, 8, 3), np.uint8)
    ro.flags.writeable = False
    with pytest.raises(ValueError, match="writable"):
        imageio.decode_batch([path], 8, 8, out=ro)
