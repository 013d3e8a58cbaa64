"""The port's native IO library (``slambench_tpu_torch/io/native.py``
building ``slambench_tpu_torch/native/slamio.cpp``): the byte-for-byte
copy of the JAX package's source, the native reader against the numpy
reader and the written frames (test_config_io.py's contract), the
native ``scene2raw`` path within 1 LSB of the numpy path
(test_scene2raw.py's contract), the ``SLAMBENCH_NATIVE_IO=0`` switch, and
a failed build raising."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

from slambench_tpu_torch.io import native  # noqa: E402
from slambench_tpu_torch.io.raw import RawWriter  # noqa: E402
from slambench_tpu_torch.io.readers import (  # noqa: E402
    SCENE_K, SCENE_SIZE, NativeBackedRawReader, RawDepthReader,
    SceneDepthReader, make_reader,
)
from slambench_tpu_torch.tools import scene2raw  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(n=3, h=12, w=16, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 5000, (h, w)).astype(np.uint16)
            for _ in range(n)]


def test_sources_are_the_jax_copies():
    for name in ("slamio.cpp", "Makefile"):
        with open(os.path.join(REPO, "slambench_tpu", "native", name),
                  "rb") as f:
            want = f.read()
        with open(os.path.join(REPO, "slambench_tpu_torch", "native", name),
                  "rb") as f:
            assert f.read() == want, name


def test_library_builds_in_the_port():
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libslamio_")
    assert native.load() is native.load()


def test_native_reader_matches_numpy_reader(tmp_path):
    path = str(tmp_path / "t.raw")
    frames = _frames()
    with RawWriter(path, 16, 12) as w:
        for f in frames:
            w.write(f)
    rn = NativeBackedRawReader(path)
    rp = RawDepthReader(path)
    assert rn.get_input_size() == rp.get_input_size() == (16, 12)
    assert rn.get_k() == rp.get_k()
    assert rn._native.n_frames == 3
    for f in frames:
        a, b = rn.read_next_depth_frame(), rp.read_next_depth_frame()
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, f)
    assert rn.read_next_depth_frame() is None


def test_native_writer_matches_raw_writer(tmp_path):
    """Frames written by ``native.write_frame`` (with and without RGB)
    are byte for byte those of the numpy ``RawWriter``."""
    frames = _frames(n=2, seed=4)
    rgb = np.random.default_rng(5).integers(0, 256, (12, 16, 3), np.uint8)
    nat, ref = str(tmp_path / "n.raw"), str(tmp_path / "r.raw")
    native.write_frame(nat, False, frames[0], rgb)
    native.write_frame(nat, True, frames[1])
    with RawWriter(ref, 16, 12) as w:
        w.write(frames[0], rgb)
        w.write(frames[1])
    with open(nat, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(OSError):
        native.write_frame(str(tmp_path / "missing" / "x.raw"), False,
                           frames[0])


def test_make_reader_native_switch(tmp_path, monkeypatch):
    path = str(tmp_path / "t.raw")
    with RawWriter(path, 16, 12) as w:
        w.write(_frames(n=1)[0])
    assert isinstance(make_reader(path), NativeBackedRawReader)
    for off in ("0", "off"):
        monkeypatch.setenv("SLAMBENCH_NATIVE_IO", off)
        assert type(make_reader(path)) is RawDepthReader


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 2-frame ICL-NUIM-shaped directory (test_scene2raw.py's field)."""
    d = tmp_path_factory.mktemp("icl_native")
    w, h = SCENE_SIZE
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    for f in range(2):
        euclid = (2.5 + 0.8 * np.sin(u / 97.0 + f)
                  * np.cos(v / 61.0 - 0.3 * f))
        euclid[(u + v + f * 11) % 197 == 0] = 0.0
        with open(d / ("scene_00_%04d.depth" % f), "w") as fh:
            np.savetxt(fh, euclid, fmt="%.6f", newline="\n")
    return d


def test_scene2raw_native_path_within_one_lsb(scene, tmp_path, monkeypatch):
    """The native parse + planarize against the numpy path: at most 1 LSB
    apart (divide-by-sqrt against multiply-by-rsqrt), equal on > 99.9% of
    pixels, zero rays zero; the parse equals numpy's float parse."""
    nat, ref = str(tmp_path / "n.raw"), str(tmp_path / "p.raw")
    assert scene2raw.convert(str(scene), nat, verbose=False) == 2
    monkeypatch.setenv("SLAMBENCH_NATIVE_IO", "0")
    assert scene2raw.convert(str(scene), ref, verbose=False) == 2
    rn, rp, rs = RawDepthReader(nat), RawDepthReader(ref), \
        SceneDepthReader(str(scene))
    for f in range(2):
        a, b = rn.read_next_depth_frame(), rp.read_next_depth_frame()
        assert np.abs(a.astype(np.int64) - b).max() <= 1
        assert np.mean(a == b) > 0.999
        assert np.abs(a.astype(np.int64) - rs.read_next_depth_frame()
                      ).max() <= 1
        w, h = SCENE_SIZE
        path = str(scene / ("scene_00_%04d.depth" % f))
        with open(path) as fh:
            want = np.array(fh.read().split()[: w * h], np.float32)
        vals = native.parse_depth_ascii(path, w * h)
        np.testing.assert_array_equal(vals, want)
        assert (a[vals.reshape(h, w) == 0] == 0).all()
    short = tmp_path / "short.depth"
    short.write_text("1.5 2.5\n3.5\n")
    np.testing.assert_array_equal(native.parse_depth_ascii(str(short), 3),
                                  np.float32([1.5, 2.5, 3.5]))
    with pytest.raises(ValueError, match="parsed 3 of 4"):
        native.parse_depth_ascii(str(short), 4)
    mm = native.planarize_mm(np.full((2, 3), 2.0, np.float32), *SCENE_K)
    assert mm.dtype == np.uint16 and mm.shape == (2, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    a missing compiler raises too. Neither falls back to numpy."""
    bad = tmp_path / "slamio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native IO build failed"):
        native.load()
    with pytest.raises(RuntimeError, match="build failed"):
        native.NativeRawReader(str(bad))
    monkeypatch.setenv("CXX", "no-such-compiler-slb")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    raw = str(tmp_path / "t.raw")
    with RawWriter(raw, 16, 12) as w:
        w.write(_frames(n=1)[0])
    with pytest.raises(RuntimeError):
        make_reader(raw)
    assert not os.listdir(tmp_path / "build")
