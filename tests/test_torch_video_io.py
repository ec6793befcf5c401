"""The port's video decode (merv_tpu_torch.preprocessing.video_io, .native) against merv_tpu's.

Same file, same backend, same sampling arguments on both sides: the uint8
frames must be equal, byte for byte. A missing backend (no g++ or libav* for
the native decoder, no cv2, no imageio or no mp4 plugin of it) skips with its reason.
"""

import gc
import shutil
import weakref
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import merv_tpu.models.vidlms.merv as jax_merv
import merv_tpu.native as jax_native
import merv_tpu.preprocessing.video_io as jax_io
import merv_tpu_torch.models.vidlms.merv as port_merv
import merv_tpu_torch.native as port_native
import merv_tpu_torch.preprocessing.video_io as port_io

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "assets" / "video_demo.mp4"
BACKENDS = ("native", "cv2", "imageio")


def _require(backend):
    """Skip unless ``backend`` opens the demo video in both packages."""
    for io in (port_io, jax_io):
        try:
            io.open_video(str(DEMO), backend=backend).close()
        except Exception as e:
            pytest.skip(f"{backend} backend unavailable ({io.__name__}): {type(e).__name__}: {e}")


# (name, load_video kwargs): the num_frames of the towers, a clip window, end_frame, the NaN guard
CASES = {
    "nf8": dict(num_frames=8),
    "nf16": dict(num_frames=16),
    "nf32": dict(num_frames=32),
    "clip_window": dict(num_frames=16, clip_start_sec=1.0, clip_end_sec=4.5),
    "end_frame": dict(num_frames=8, end_frame=20),
    "nan_guard": dict(num_frames=8, clip_start_sec=float("nan"), clip_end_sec=float("nan")),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_load_video_matches_jax(backend, case):
    _require(backend)
    kw = CASES[case]
    ref = jax_io.load_video(DEMO, backend=backend, **kw)
    out = port_io.load_video(DEMO, backend=backend, **kw)
    assert out.dtype == np.uint8 and out.shape == ref.shape == (kw["num_frames"], 128, 128, 3)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_known_bad_file_chunked_redecode_matches_jax(backend, tmp_path):
    _require(backend)
    bad = tmp_path / sorted(port_io._KNOWN_BAD_CHUNKED)[0]
    shutil.copy(DEMO, bad)
    np.testing.assert_array_equal(port_io.load_video(bad, 32, backend=backend),
                                  jax_io.load_video(bad, 32, backend=backend))


def _frames(n, h=24, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)


def test_gif_matches_jax(tmp_path):
    gif = tmp_path / "clip.gif"
    imgs = [Image.fromarray(f) for f in _frames(7)]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=100, loop=0)
    for nf in (4, 8):
        out, ref = port_io.load_video(gif, nf), jax_io.load_video(gif, nf)
        assert out.shape == (nf, 24, 32, 3)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reader_matches_jax_on_a_gif(backend, tmp_path):
    """Each reader on its own (imageio reads GIFs without an ffmpeg plugin)."""
    gif = tmp_path / "clip.gif"
    imgs = [Image.fromarray(f) for f in _frames(6, seed=3)]
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=125, loop=0)
    readers = []
    for io in (port_io, jax_io):
        try:
            readers.append(io.open_video(str(gif), backend=backend))
        except Exception as e:
            pytest.skip(f"{backend} cannot open a GIF here ({io.__name__}): {type(e).__name__}: {e}")
    mine, theirs = readers
    try:
        assert (len(mine), mine.get_avg_fps()) == (len(theirs), theirs.get_avg_fps())
        ids = [len(mine) - 1, 0, 2, 2]
        np.testing.assert_array_equal(mine.get_batch(ids), theirs.get_batch(ids))
    finally:
        mine.close()
        theirs.close()


@pytest.mark.parametrize("layout", ["vlep", "sharegpt"])
def test_frame_dir_matches_jax(layout, tmp_path):
    d = tmp_path / f"{layout}_clip_0"
    d.mkdir()
    ext = "jpg" if layout == "vlep" else "jpeg"
    for i, f in enumerate(_frames(13, seed=1)):
        Image.fromarray(f).save(d / f"{i:03d}.{ext}")
    cases = [dict(num_frames=5)]
    if layout == "vlep":  # 3 fps: the clip window picks frames by time
        cases.append(dict(num_frames=4, clip_start_sec=1.0, clip_end_sec=3.0))
    for kw in cases:
        out, ref = port_io.load_video(d, **kw), jax_io.load_video(d, **kw)
        assert out.shape == (kw["num_frames"], 24, 32, 3)
        np.testing.assert_array_equal(out, ref)


def test_load_media_image_matches_jax(tmp_path):
    png = tmp_path / "frame.png"
    Image.fromarray(_frames(1, seed=2)[0]).save(png)
    out, ref = port_merv._load_media(png, 16), jax_merv._load_media(png, 16)
    assert out.shape == (16, 24, 32, 3)
    np.testing.assert_array_equal(out, ref)
    # a video path goes through load_video with the clip window
    kw = dict(clip_start_sec=0.5, clip_end_sec=3.0)
    np.testing.assert_array_equal(port_merv._load_media(DEMO, 8, **kw), jax_merv._load_media(DEMO, 8, **kw))


def test_open_video_auto_picks_native_first():
    _require("native")
    for io in (port_io, jax_io):
        r = io.open_video(str(DEMO))
        assert isinstance(r, io.NativeVideoReader)
        r.close()


def test_native_decoder_gives_merv_tpus_bytes():
    """The port's decoder, built from its copy of videodec.cpp into its own
    build directory, decodes every frame, and resizes, to merv_tpu's bytes."""
    _require("native")
    assert port_native._SRC.read_bytes() == (Path(jax_native.__file__).parent / "videodec.cpp").read_bytes()
    assert port_native._SO.parent == REPO / "merv_tpu_torch" / "_build"
    mine, theirs = port_native.videodec.VideoReader(str(DEMO)), jax_native.videodec.VideoReader(str(DEMO))
    try:
        assert (mine.num_frames(), mine.avg_fps(), mine.width, mine.height) == \
            (theirs.num_frames(), theirs.avg_fps(), theirs.width, theirs.height)
        ids = list(range(mine.num_frames()))[::-1]  # backwards: every frame a seek
        np.testing.assert_array_equal(mine.get_batch(ids), theirs.get_batch(ids))
        np.testing.assert_array_equal(mine.get_batch_resized([0, 17, 40], 96, 80),
                                      theirs.get_batch_resized([0, 17, 40], 96, 80))
    finally:
        mine.close()
        theirs.close()


def test_native_library_with_a_stale_record_is_rebuilt(tmp_path, monkeypatch):
    """A library whose source-hash record does not match is rebuilt, never opened."""
    _require("native")
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native, "_SO", tmp_path / "libvideodec.so")
    monkeypatch.setattr(port_native, "_HASH", tmp_path / "libvideodec.so.srchash")
    port_native._SO.write_bytes(b"not a library")
    port_native._HASH.write_text("0" * 64)
    lib = port_native._load()
    assert port_native._HASH.read_text() == port_native._src_hash()
    assert lib.vr_open(b"/nonexistent.mp4") is None


def test_no_native_switch_falls_back(monkeypatch):
    """MERV_TPU_NO_NATIVE=1, read when the library is first loaded, keeps it unloaded."""
    monkeypatch.setenv("MERV_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_error", None)
    for _ in range(2):  # the failure is kept, not retried
        with pytest.raises(ImportError, match="MERV_TPU_NO_NATIVE"):
            port_native.get_lib()
    try:
        r = port_io.open_video(str(DEMO))
    except IOError as e:
        pytest.skip(f"no python video backend here: {e}")
    assert not isinstance(r, port_io.NativeVideoReader)
    r.close()


def test_a_kept_decoder_failure_keeps_no_caller_alive(monkeypatch):
    """The kept failure must not hold the frames it was raised through: on a
    machine without the decoder, each request's frame (and its model) would
    stay alive."""
    monkeypatch.setenv("MERV_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_error", None)

    class Model:
        pass

    def request(model):
        try:
            port_native.get_lib()
        except ImportError:
            pass

    model = Model()
    alive = weakref.ref(model)
    request(model)
    request(model)
    del model
    gc.collect()
    assert alive() is None


def test_open_video_names_the_last_failure(tmp_path):
    with pytest.raises(IOError, match="no video backend could open .*missing.mp4"):
        port_io.open_video(str(tmp_path / "missing.mp4"))
