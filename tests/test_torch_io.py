"""Port parity for the inputs: the reader dispatch, the ICL-NUIM scene
reader, the ``.scf`` camera override, the ONI container and its 16z
codec, and the ``oni2raw`` / ``scene2raw`` converters, each held against
the JAX package on the same bytes (test_config_io.py, test_oni.py and
test_scene2raw.py mirrored on the port)."""

import math
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from slambench_tpu.config import Configuration as JConfiguration  # noqa: E402
from slambench_tpu.io import oni as joni  # noqa: E402
from slambench_tpu.io import readers as jreaders  # noqa: E402
from slambench_tpu.tools import oni2raw as joni2raw  # noqa: E402
from slambench_tpu.tools import scene2raw as jscene2raw  # noqa: E402

from slambench_tpu_torch.config import parse_args  # noqa: E402
from slambench_tpu_torch.io import oni  # noqa: E402
from slambench_tpu_torch.io.raw import (  # noqa: E402
    RawWriter, frame_nbytes, raw_frame_count,
)
from slambench_tpu_torch.io.readers import (  # noqa: E402
    SCENE_K, SCENE_SIZE, NativeBackedRawReader, RawDepthReader,
    SceneDepthReader, make_reader,
)
from slambench_tpu_torch.tools import oni2raw, scene2raw  # noqa: E402

W, H = SCENE_SIZE
N_FRAMES = 3


def _write_depth(path, euclid):
    with open(path, "w") as fh:
        np.savetxt(fh, euclid, fmt="%.6f", newline="\n")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """test_scene2raw.py's ICL-NUIM-shaped directory: ASCII euclidean
    ray lengths, 1.5-3.5 m, with zero rays."""
    d = tmp_path_factory.mktemp("icl_scene_torch")
    u = np.arange(W, dtype=np.float64)[None, :]
    v = np.arange(H, dtype=np.float64)[:, None]
    euclids = []
    for f in range(N_FRAMES):
        euclid = (2.5 + 0.8 * np.sin(u / 97.0 + f)
                  * np.cos(v / 61.0 - 0.3 * f))
        euclid[(u + v + f * 11) % 197 == 0] = 0.0
        euclids.append(euclid)
        _write_depth(d / ("scene_00_%04d.depth" % f), euclid)
    return d, euclids


def test_scene_constants_match_jax():
    assert SCENE_K == jreaders.SCENE_K and SCENE_K[1] < 0
    assert SCENE_SIZE == jreaders.SCENE_SIZE


def test_scene_depth_reader_matches_jax(scene):
    """Equal uint16 frames from the port's and JAX's scene readers; zero
    rays stay zero."""
    scene_dir, euclids = scene
    rt = SceneDepthReader(str(scene_dir))
    rj = jreaders.SceneDepthReader(str(scene_dir))
    assert rt.camera_open and rt.get_input_size() == (W, H)
    assert rt.get_k() == rj.get_k() == (481.20, 480.00, 319.50, 239.50)
    for f in range(N_FRAMES):
        a, b = rt.read_next_depth_frame(), rj.read_next_depth_frame()
        assert a.dtype == np.uint16 and a.shape == (H, W)
        np.testing.assert_array_equal(a, b)
        assert (a[euclids[f] == 0.0] == 0).all()
    assert rt.read_next_depth_frame() is None


def test_scene_reader_truncates_like_jax(tmp_path):
    """No clip before the uint16 cast: a 70 m ray gives JAX's value."""
    euclid = np.full((H, W), 1.2345678, np.float64)
    euclid[0, :8] = 70.0
    euclid[1, :8] = 0.0009
    _write_depth(tmp_path / "scene_00_0000.depth", euclid)
    with np.errstate(invalid="ignore"):
        a = SceneDepthReader(str(tmp_path)).read_next_depth_frame()
        b = jreaders.SceneDepthReader(str(tmp_path)).read_next_depth_frame()
    np.testing.assert_array_equal(a, b)
    assert (a[1, :8] == 0).all()


def test_make_reader_dispatch(tmp_path, scene, monkeypatch):
    """A file gets the native-backed reader (the numpy RawDepthReader
    with SLAMBENCH_NATIVE_IO=0), a directory the scene reader, a .scf
    its target's reader."""
    path = str(tmp_path / "t.raw")
    with RawWriter(path, 16, 12) as w:
        w.write(np.zeros((12, 16), np.uint16))
    assert isinstance(make_reader(path), NativeBackedRawReader)
    assert isinstance(make_reader(str(scene[0])), SceneDepthReader)
    scf = tmp_path / "scene.scf"
    scf.write_text('input_file = "t.raw"\n')
    assert isinstance(make_reader(str(scf)), NativeBackedRawReader)
    monkeypatch.setenv("SLAMBENCH_NATIVE_IO", "0")
    assert type(make_reader(path)) is RawDepthReader
    assert type(make_reader(str(scf))) is RawDepthReader
    (tmp_path / "empty.scf").write_text("# no input\n")
    assert make_reader(str(tmp_path / "empty.scf")) is None
    assert make_reader(str(tmp_path / "missing.nope")) is None


def test_scf_camera_override_matches_jax(tmp_path, scene):
    """A ``.scf`` naming a scene directory by a relative path and
    setting the camera: the port's config takes the same camera as
    JAX's and the reader is the scene reader."""
    scene_dir = scene[0]
    scf = scene_dir.parent / "cam.scf"
    scf.write_text("# ICL-NUIM scene\n"
                   f'input_file = "{scene_dir.name}"\n'
                   "camera = 481.2,480,320,240\n")
    cfg = parse_args(["-i", str(scf)])
    jcfg = JConfiguration()
    jcfg.input_file = str(scf)
    assert not cfg.camera_overrided
    rd = make_reader(cfg)
    jreaders.make_reader(jcfg)
    assert isinstance(rd, SceneDepthReader)
    assert cfg.camera_overrided and jcfg.camera_overrided
    assert tuple(cfg.camera) == tuple(jcfg.camera) == (481.2, 480, 320, 240)


def _frames(n=3, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = (rng.random((h, w)) * 5000).astype(np.uint16)
        d[rng.random((h, w)) < 0.2] = 0
        out.append(d)
    return out


def _write_oni(module, path, frames, codec):
    h, w = frames[0].shape
    wr = module.OniWriter(path, w, h, codec=codec)
    for i, d in enumerate(frames):
        wr.write(d, timestamp_us=33333 * i)
    wr.close()


def _read_oni(module, path):
    rd = module.OniReader(path)
    got = list(rd.depth_frames())
    rd.close()
    return got, rd.depth_node


@pytest.mark.parametrize("codec", [b"UNC_", b"16zP", b"16zT"])
def test_oni_roundtrip_matches_jax(tmp_path, codec):
    """The port's writer gives JAX's bytes; each package reads the
    other's recording back to the frames."""
    frames = _frames()
    pt, pj = str(tmp_path / "t.oni"), str(tmp_path / "j.oni")
    _write_oni(oni, pt, frames, codec)
    _write_oni(joni, pj, frames, codec)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    for module, path in ((oni, pj), (joni, pt), (oni, pt)):
        got, node = _read_oni(module, path)
        assert len(got) == len(frames)
        for a, b in zip(got, frames):
            np.testing.assert_array_equal(a, b)
        assert node.resolution == (16, 12) and node.name == b"Depth1"


def test_16z_codec_matches_jax():
    rng = np.random.default_rng(1)
    d = (rng.random(640) * 65535).astype(np.uint16)
    d[100:140] = 0
    packed = oni._compress_depth_16z(d)
    assert packed == joni._compress_depth_16z(d)
    np.testing.assert_array_equal(oni._uncompress_depth_16z(packed, d.size),
                                  d)
    # Hand-built nibble stream: a zero run of 3, a literal 100, then the
    # deltas +2 and +1.
    stream = bytes([0xF3, 0xFF, 100, 0, 0x87])
    np.testing.assert_array_equal(oni._uncompress_depth_16z(stream, 6),
                                  [0, 0, 0, 100, 102, 103])


def _record_offsets(blob):
    needle = struct.pack("<I", 0x0052494E)
    hits, i = [], blob.find(needle)
    while i >= 0:
        hits.append(i)
        i = blob.find(needle, i + 1)
    return hits


def test_oni_resync_on_corruption(tmp_path):
    """A trashed NEW_DATA header loses that frame only, as in JAX."""
    path = str(tmp_path / "rec.oni")
    frames = _frames(4)
    _write_oni(oni, path, frames, b"UNC_")
    blob = bytearray(open(path, "rb").read())
    second_data = _record_offsets(blob)[5]
    blob[second_data:second_data + 4] = b"XXXX"
    open(path, "wb").write(bytes(blob))
    got, _ = _read_oni(oni, path)
    want, _ = _read_oni(joni, path)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[-1], frames[-1])


def test_oni_corrupt_tail_terminates(tmp_path):
    path = str(tmp_path / "rec.oni")
    frames = _frames(2)
    _write_oni(oni, path, frames, b"UNC_")
    blob = bytearray(open(path, "rb").read())
    last = _record_offsets(blob)[-1]
    blob[last:last + 4] = b"XXXX"
    blob += b"\x4e" * 41
    open(path, "wb").write(bytes(blob))
    got, _ = _read_oni(oni, path)
    assert len(got) == 2
    np.testing.assert_array_equal(got[1], frames[1])


def test_oni_bad_magic(tmp_path):
    path = str(tmp_path / "not.oni")
    open(path, "wb").write(b"RIFFxxxx")
    with pytest.raises(ValueError, match="not an ONI recording"):
        oni.OniReader(path)


def test_oni2raw_cli_matches_jax(tmp_path):
    """.oni -> RAW through both packages' CLIs: the same bytes, read
    back to the frames; and the dump-directory mode."""
    src = str(tmp_path / "rec.oni")
    frames = _frames(3, h=24, w=32, seed=2)
    _write_oni(oni, src, frames, b"16zT")
    out_t, out_j = str(tmp_path / "t.raw"), str(tmp_path / "j.raw")
    assert oni2raw.main([src, out_t]) == 0
    assert joni2raw.main([src, out_j]) == 0
    assert open(out_t, "rb").read() == open(out_j, "rb").read()
    rd = RawDepthReader(out_t)
    for want in frames:
        np.testing.assert_array_equal(rd.read_next_depth_frame(), want)
    assert rd.read_next_depth_frame() is None

    dump = tmp_path / "dump"
    dump.mkdir()
    for i, d in enumerate(frames):
        np.save(dump / f"d{i:03d}.npy", d)
    out_d = str(tmp_path / "d.raw")
    assert oni2raw.main([str(dump), out_d]) == 0
    assert open(out_d, "rb").read() == open(out_t, "rb").read()
    assert oni2raw.main([src]) == 1


def _independent_planar_mm(euclid, pixels):
    """scene2raw.cpp:97-109 per pixel in double precision, truncated."""
    fx, fy, cx, cy = SCENE_K
    out = []
    for (vv, uu) in pixels:
        ux = (uu - cx) / fx
        vy = (vv - cy) / fy
        mm = euclid[vv, uu] * 1000.0 / math.sqrt(ux * ux + vy * vy + 1.0)
        out.append(int(min(max(mm, 0.0), 65535.0)))
    return np.asarray(out, np.int64)


def test_scene2raw_numpy_path_roundtrip(scene, tmp_path, monkeypatch):
    """The port's converter against an independent f64 planarization
    (1 LSB), and byte for byte against the JAX converter's numpy path."""
    scene_dir, euclids = scene
    monkeypatch.setenv("SLAMBENCH_NATIVE_IO", "0")
    out = tmp_path / "np.raw"
    assert scene2raw.convert(str(scene_dir), str(out), verbose=False) \
        == N_FRAMES
    assert raw_frame_count(str(out)) == N_FRAMES
    assert out.stat().st_size == N_FRAMES * frame_nbytes(W, H)
    monkeypatch.setattr(jscene2raw.native, "available", lambda: False)
    jout = tmp_path / "jnp.raw"
    jscene2raw.convert(str(scene_dir), str(jout), verbose=False)
    assert out.read_bytes() == jout.read_bytes()

    rd = RawDepthReader(str(out))
    rng = np.random.default_rng(3)
    pixels = list(zip(rng.integers(0, H, 400), rng.integers(0, W, 400)))
    for f in range(N_FRAMES):
        depth = rd.read_next_depth_frame()
        expected = _independent_planar_mm(euclids[f], pixels)
        got = np.asarray([int(depth[vv, uu]) for vv, uu in pixels])
        assert np.max(np.abs(got - expected)) <= 1
        assert np.mean(got == expected) > 0.95
        assert (depth[euclids[f] == 0.0] == 0).all()
    assert rd.read_next_depth_frame() is None
    assert scene2raw.main([str(scene_dir)]) == 1


def test_scene_reader_agrees_with_converter(scene, tmp_path, monkeypatch):
    """The scene reader equals the converter's numpy path frame for
    frame, and its native path within 1 LSB on < 0.1% of pixels
    (test_scene2raw.py's native contract)."""
    scene_dir, _ = scene
    out, nat = tmp_path / "cmp.raw", tmp_path / "nat.raw"
    scene2raw.convert(str(scene_dir), str(nat), verbose=False)
    monkeypatch.setenv("SLAMBENCH_NATIVE_IO", "0")
    scene2raw.convert(str(scene_dir), str(out), verbose=False)
    sr = SceneDepthReader(str(scene_dir))
    rr, nr = RawDepthReader(str(out)), RawDepthReader(str(nat))
    for _ in range(N_FRAMES):
        want = sr.read_next_depth_frame()
        np.testing.assert_array_equal(want, rr.read_next_depth_frame())
        got = nr.read_next_depth_frame().astype(np.int64)
        assert np.abs(got - want).max() <= 1
        assert np.mean(got == want) > 0.999
