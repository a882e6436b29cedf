"""PyTorch port, synthetic data and dataset IO vs the JAX package on the CPU.

- Scenes and primitives: the SDF at 10 000 seeded points within 1e-6.
- Trajectories: the numpy copies equal to the bit; ``perturbed_poses`` within 1e-6.
- ``render_depth``: valid masks differ on at most 0.1% of the pixels; depths
  within 1e-4 m on all but 0.1% of the pixels valid in both, and within 2e-3 m
  on every one (sphere tracing stops inside a 1 mm band; an ulp-level
  difference in a step can stop the march one step later there).
- The depth PNG codec: equal decoded samples both ways against the reference's
  C codec (``native/loader.py``), the same file bytes, and equal samples
  against PIL files whose rows carry the Sub, Up, Average and Paeth filters.
- The ``.erts`` container both ways, bit-equal frames.
- ``generate_synthetic`` on the same arguments: equal intrinsics and gt.log,
  depth PNGs equal on all but 0.1% of the pixels, within 1 mm on every one.
"""

import json
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticreconstruction_tpu.core import camera as j_cam
from elasticreconstruction_tpu.core import stream as j_stream
from elasticreconstruction_tpu.native import loader as j_loader
from elasticreconstruction_tpu.pipeline import dataset as j_dataset
from elasticreconstruction_tpu.synthetic import render as j_render
from elasticreconstruction_tpu.synthetic import scenes as j_scenes
from elasticreconstruction_tpu.synthetic import sdf as j_sdf
from elasticreconstruction_tpu_torch import interop
from elasticreconstruction_tpu_torch.core import stream as t_stream
from elasticreconstruction_tpu_torch.native import depth_png
from elasticreconstruction_tpu_torch.pipeline import dataset as t_dataset
from elasticreconstruction_tpu_torch.synthetic import render as t_render
from elasticreconstruction_tpu_torch.synthetic import scenes as t_scenes
from elasticreconstruction_tpu_torch.synthetic import sdf as t_sdf

INTR = j_cam.Intrinsics(fx=100.0, fy=100.0, cx=59.5, cy=44.5, width=120, height=90)
T_INTR = interop.intrinsics_from(INTR)

SCENES = {
    "livingroom": lambda m: m.livingroom_scene(),
    "livingroom_bare": lambda m: m.livingroom_scene(bare_minus_z=True),
    "livingroom2": lambda m: m.livingroom2_scene(),
    "office": lambda m: m.office_scene(),
}
PRIMITIVES = {
    "sphere": lambda m: m.sphere((0.1, 0.2, -0.3), 0.7),
    "box": lambda m: m.box((0.2, -0.1, 0.0), (0.5, 0.3, 0.8)),
    "rounded_box": lambda m: m.rounded_box((0.0, 0.4, 0.1), (0.4, 0.2, 0.3), 0.05),
    "cylinder_y": lambda m: m.cylinder_y((0.3, 0.0, -0.2), 0.4, 0.6),
    "shell": lambda m: m.shell(m.box((0, 0, 0), (1.0, 0.8, 0.9)), 0.1),
    "intersect": lambda m: m.intersect(m.sphere((0, 0, 0), 1.0), m.box((0.3, 0, 0), (0.6, 0.6, 0.6))),
    "subtract": lambda m: m.subtract(m.box((0, 0, 0), (1.0, 1.0, 1.0)), m.sphere((0.5, 0, 0), 0.6)),
    "invert_union": lambda m: m.invert(m.union(m.sphere((0, 0, 0), 0.5), m.sphere((0.7, 0, 0), 0.4))),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once, and
    torch's thread pool spinning against the other workers' slows these small
    ops by two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _points(lo, hi, n=10000, seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SCENES) + sorted(PRIMITIVES))
def test_sdf_matches_jax(name):
    make = SCENES.get(name) or PRIMITIVES[name]
    pts = _points((-3.6, -0.3, -2.7), (3.6, 3.3, 2.7)) if name in SCENES else _points(-1.5, 1.5)
    want = np.array(jax.jit(make(j_sdf if name in PRIMITIVES else j_scenes))(jnp.asarray(pts)))
    got = make(t_sdf if name in PRIMITIVES else t_scenes)(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)  # tolerance: 1e-6


def test_sdf_normal_matches_jax():
    pts = _points(-1.5, 1.5, 2000)
    want = np.array(j_sdf.normal(PRIMITIVES["rounded_box"](j_sdf), jnp.asarray(pts)))
    got = t_sdf.normal(PRIMITIVES["rounded_box"](t_sdf), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)  # tolerance: finite differences at eps 1e-4 in f32


def test_trajectories_are_the_reference_s():
    for name, kw in (("orbit_trajectory", dict(radius=1.1, sweep=0.4)), ("pendulum_trajectory", {}),
                     ("survey_trajectory", dict(sweep=3.0))):
        np.testing.assert_array_equal(getattr(t_scenes, name)(37, **kw), getattr(j_scenes, name)(37, **kw))
    np.testing.assert_array_equal(t_scenes.look_at_pose((0, 1, 0), (0, 5, 0)), j_scenes.look_at_pose((0, 1, 0), (0, 5, 0)))
    poses = j_scenes.orbit_trajectory(9)
    np.testing.assert_allclose(t_scenes.perturbed_poses(poses, 0.01, 0.02, seed=3),
                               j_scenes.perturbed_poses(poses, 0.01, 0.02, seed=3), atol=1e-6)  # tolerance: 1e-6


@pytest.fixture(scope="module")
def rendered():
    poses = np.concatenate([
        j_scenes.orbit_trajectory(5, radius=1.0, height=1.3, sweep=0.35, start_angle=0.7),
        j_scenes.survey_trajectory(4, sweep=2.0, start_angle=2.0),
    ])
    want = np.array(j_render.render_sequence(j_scenes.livingroom_scene(), jnp.asarray(poses), INTR, max_depth=6.0))
    got = t_render.render_sequence(t_scenes.livingroom_scene(), torch.from_numpy(poses), T_INTR,
                                   max_depth=6.0, batch=4).numpy()
    return want, got, poses


def test_render_depth_matches_jax(rendered):
    want, got, _ = rendered
    assert got.shape == want.shape == (9, 90, 120)
    assert ((want > 0) != (got > 0)).mean() <= 1e-3  # tolerance: 0.1% of the pixels
    both = (want > 0) & (got > 0)
    assert both.mean() > 0.95
    diff = np.abs(want - got)[both]
    assert (diff > 1e-4).mean() <= 1e-3 and diff.max() < 2e-3, (diff.max(), (diff > 1e-4).mean())


def test_render_depth_single_frame_and_sphere():
    """One frame through ``render_depth`` equals that frame of a batch; a ray along
    +z hits the analytic sphere at its front."""
    sphere = t_sdf.sphere((0.0, 0.0, 2.0), 0.5)
    d = t_render.render_depth(sphere, torch.eye(4), T_INTR).numpy()
    assert abs(d[44, 59] - 1.5) < 2e-3 and d[0, 0] == 0.0
    batch = t_render.render_batch(sphere, torch.eye(4).repeat(3, 1, 1), T_INTR).numpy()
    np.testing.assert_array_equal(batch[1], d)


# ------------------------------------------------------------------ depth PNG codec


def _png_rows(path):
    """(bit depth, the filter byte of every row) of a grayscale PNG."""
    buf = open(path, "rb").read()
    pos, idat, depth, width = 8, b"", 0, 0
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        kind, data = buf[pos + 4 : pos + 8], buf[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            width, depth = struct.unpack(">I", data[:4])[0], data[8]
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = width * depth // 8 + 1
    return depth, {raw[k] for k in range(0, len(raw), stride)}


@pytest.fixture(scope="module")
def depth_map():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 6, (120, 160)).astype(np.float32)
    d[d < 0.5] = 0.0
    return d


def test_png_codec_against_the_c_codec(tmp_path, depth_map):
    assert j_loader.native_available()
    c_file, py_file = tmp_path / "c.png", tmp_path / "py.png"
    j_loader.write_depth(c_file, depth_map)
    depth_png.write_depth(py_file, depth_map)
    np.testing.assert_array_equal(depth_png.read_depth(c_file), j_loader.read_depth(c_file))
    np.testing.assert_array_equal(j_loader.read_depth(py_file), depth_png.read_depth(py_file))
    np.testing.assert_array_equal(depth_png.read_depth(py_file), np.round(depth_map * 1000) / np.float32(1000))
    assert py_file.read_bytes() == c_file.read_bytes()  # same filter, level and zlib
    assert _png_rows(py_file) == (16, {0})
    batch = depth_png.read_depth_batch([c_file, py_file, c_file], 160, 120, threads=2)
    np.testing.assert_array_equal(batch, j_loader.read_depth_batch([c_file, py_file, c_file], 160, 120))
    with pytest.raises(ValueError, match="expected 80x60"):
        depth_png.read_depth_batch([c_file], 80, 60)


def _encode_with_filters(arr: np.ndarray) -> bytes:
    """A grayscale PNG of ``arr`` (uint8 or uint16) whose row ``y`` carries filter ``y % 5``."""
    bpp = arr.dtype.itemsize
    h, w = arr.shape
    rows = np.ascontiguousarray(arr.astype(arr.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, w * bpp)
    out, prev = bytearray(), [0] * (w * bpp)
    for y in range(h):
        cur, kind = rows[y].tolist(), y % 5
        out.append(kind)
        for x, v in enumerate(cur):
            a = cur[x - bpp] if x >= bpp else 0
            b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (b if abs(p - b) <= abs(p - c) else c)
            out.append((v - (0, a, b, (a + b) // 2, paeth)[kind]) & 0xFF)
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8 * bpp, 0, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("mode", ["I;16", "L"])
def test_png_codec_reads_every_row_filter(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[:64, :96]
    img = (1500 + 900 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + xx * yy).astype(np.int64)
    img[20:30] = rng.integers(0, 4000, (10, 96))
    img[40:44] = 777
    arr = (img % 256).astype(np.uint8) if mode == "L" else img.astype(np.uint16)
    # PIL's own file (adaptive filtering mixes several filters) ...
    if mode == "L":
        Image.fromarray(arr, mode="L").save(tmp_path / "pil.png")
    else:
        Image.fromarray(arr.astype(np.int32), mode="I").convert("I;16").save(tmp_path / "pil.png")
    depth, filters = _png_rows(tmp_path / "pil.png")
    assert depth == 8 * arr.dtype.itemsize and len(filters) >= 3, filters
    # ... and one with every filter, row by row, read by PIL as the reference decoder.
    (tmp_path / "all.png").write_bytes(_encode_with_filters(arr))
    assert _png_rows(tmp_path / "all.png")[1] == {0, 1, 2, 3, 4}
    for name in ("pil.png", "all.png"):
        got = depth_png.read_depth_u16(tmp_path / name)
        np.testing.assert_array_equal(got, arr.astype(np.uint16))
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / name)).astype(np.uint16))
        np.testing.assert_array_equal(depth_png.read_depth(tmp_path / name), j_loader.read_depth(tmp_path / name))


def test_png_codec_rejects_what_the_c_codec_rejects(tmp_path):
    from PIL import Image

    (tmp_path / "junk.png").write_bytes(b"not a png at all")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "rgb.png")
    for name in ("junk.png", "rgb.png"):
        with pytest.raises(ValueError):
            depth_png.read_depth(tmp_path / name)


# ------------------------------------------------------------------ stream container


def test_stream_container_both_ways(tmp_path, depth_map):
    frames = [depth_map, depth_map * 0.5, np.zeros_like(depth_map)]
    intr = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
    for writer, reader, name in ((t_stream.StreamWriter, j_stream.StreamReader, "t.erts"),
                                 (j_stream.StreamWriter, t_stream.StreamReader, "j.erts")):
        with writer(tmp_path / name, intr) as w:
            for f in frames:
                w.append(f)
        r = reader(tmp_path / name)
        assert len(r) == 3 and r.header["intrinsics"] == intr
        np.testing.assert_array_equal(r.depth_chunk(0, 3), np.round(np.stack(frames) * 1000) / np.float32(1000))
    assert (tmp_path / "t.erts").read_bytes() == (tmp_path / "j.erts").read_bytes()


# ------------------------------------------------------------------ dataset


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same small synthetic sequence written by both packages."""
    root = tmp_path_factory.mktemp("synth")
    intr = j_cam.Intrinsics(fx=50.0, fy=50.0, cx=29.5, cy=22.5, width=60, height=45)
    kw = dict(num_frames=18, scene="office", trajectory="orbit", radius=1.1, sweep=0.8, seed=5, depth_noise=0.01)
    j_dataset.generate_synthetic(root / "jax", intr=intr, **kw)
    t_dataset.generate_synthetic(root / "torch", intr=interop.intrinsics_from(intr), device="cpu", **kw)
    return root


def test_generate_synthetic_matches_jax(datasets):
    jd, td = j_dataset.Dataset(datasets / "jax"), t_dataset.Dataset(datasets / "torch")
    assert len(td) == len(jd) == 18 and tuple(td.intrinsics) == tuple(jd.intrinsics)
    assert (datasets / "torch" / "gt.log").read_text() == (datasets / "jax" / "gt.log").read_text()
    np.testing.assert_array_equal(td.gt_poses, jd.gt_poses)
    a, b = td.depth_chunk(0, 18), jd.depth_chunk(0, 18)
    assert a.shape == (18, 45, 60)
    assert (a != b).mean() <= 1e-3 and np.abs(a - b).max() <= 1e-3 + 1e-6  # tolerance: 0.1% / 1 mm
    assert td.distortion is None and td.distortion_json is None


def test_dataset_layouts(datasets, tmp_path):
    td = t_dataset.Dataset(datasets / "torch")
    np.testing.assert_array_equal(td.depth(3), td.depth_chunk(3, 1)[0])
    assert td.depth_chunk(16, 5).shape == (2, 45, 60)
    # The stream layout wins when both are present, with the same frames.
    import shutil

    shutil.copytree(datasets / "torch", tmp_path / "ds")
    t_stream.pack_stream(tmp_path / "ds")
    sd = t_dataset.Dataset(tmp_path / "ds")
    assert sd.stream is not None and tuple(sd.intrinsics) == tuple(td.intrinsics)
    np.testing.assert_array_equal(sd.depth_chunk(0, 18), td.depth_chunk(0, 18))
    jd = j_dataset.Dataset(tmp_path / "ds")
    np.testing.assert_array_equal(jd.depth_chunk(0, 18), sd.depth_chunk(0, 18))
    # distortion.json is kept as text; reading the field raises until the module is ported.
    (tmp_path / "ds" / "distortion.json").write_text(json.dumps({"kind": "any"}))
    dd = t_dataset.Dataset(tmp_path / "ds")
    assert dd.distortion_json == json.dumps({"kind": "any"})
    with pytest.raises(NotImplementedError, match="distortion"):
        dd.distortion
    with pytest.raises(NotImplementedError, match="distortion"):
        t_dataset.generate_synthetic(tmp_path / "x", num_frames=1, distortion=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        t_dataset.generate_synthetic(tmp_path / "y", num_frames=1, scene="garden", device="cpu")
